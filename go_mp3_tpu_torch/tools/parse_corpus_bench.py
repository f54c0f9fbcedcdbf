"""The full-corpus parse probe, the host term of the bench's ceilings.

    python -m go_mp3_tpu_torch.tools.parse_corpus_bench [REPS] [--compute-s S]

Counterpart of tools/parse_corpus_bench.py: the bench's geometry pass and
parse probe alone (go_mp3_tpu_torch/bench.py: geometry, alloc_pool,
parse_sample), to compare parser changes quickly. The smoke corpus
(tools/corpus.py corpus_lanes) at GOMP3_N_CLASSIC and GOMP3_N_MPEG2 lanes
and GOMP3_CHUNK_T granules a chunk, BatchParser.parse_chunk_into over a
reused pool, process CPU time, min and median over REPS samples (7). Host
only: it needs no card. The ceiling audio / (parse + compute) is printed
only given the card's compute seconds for the whole corpus (--compute-s,
e.g. the bench's probe_scan_total_s): a ceiling computed from two probes,
not a measurement.
"""

from __future__ import annotations

import argparse
import statistics
import sys

import numpy as np

from ..bench import Settings, alloc_pool, geometry, parse_sample
from .corpus import corpus_lanes


def probe(lanes: list[bytes], chunk_t: int, reps: int) -> dict:
    """-> granules, n_chunks, audio_seconds and the samples' process CPU
    and wall seconds (lists of `reps`)."""
    geo = geometry(lanes, chunk_t)
    pool = alloc_pool(geo.n_chunks, len(lanes), chunk_t)
    valids = np.zeros((geo.n_chunks, len(lanes)), np.int32)
    cpu, wall = [], []
    for r in range(reps):
        w, c = parse_sample(lanes, pool, valids)
        cpu.append(c)
        wall.append(w)
        print(f"rep {r}: cpu {c:.4f}s wall {w:.4f}s", file=sys.stderr)
    return {"granules": geo.total_granules, "n_chunks": geo.n_chunks,
            "audio_seconds": geo.audio_seconds, "cpu_s": cpu, "wall_s": wall}


def summary(p: dict, compute_s: float | None = None) -> str:
    mn, md = min(p["cpu_s"]), statistics.median(p["cpu_s"])
    line = (f"parse full corpus ({p['granules']} gr, {p['n_chunks']} chunks): cpu min "
            f"{mn:.4f}s med {md:.4f}s ({p['granules'] / mn / 1e3:.0f}k gr/s min)")
    if compute_s is not None:
        a = p["audio_seconds"]
        line += (f" ceiling-at-{compute_s}s-compute (computed) min {a / (mn + compute_s):.0f}x"
                 f" med {a / (md + compute_s):.0f}x")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=7)
    ap.add_argument("--compute-s", type=float, default=None,
                    help="the card's compute seconds for the corpus, for the ceiling")
    args = ap.parse_args(argv)
    s = Settings.from_env()
    p = probe(corpus_lanes(s.n_escape, s.n_lowrate), s.chunk_t, args.reps)
    print(summary(p, args.compute_s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
