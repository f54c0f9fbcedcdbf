"""The output check's control: the plain reference, computed in TF32, in the
program's place.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

The configuration states float32 with no TF32; the control computes the
same answers that a run of the cell compares (as many, drawn as a run
draws them, from the cell's inputs at its own sizes) with the reference's
DSP in TF32 (dsp.py precision "tf32"), and holds them against the float64
reference as a run holds the program's. It has to come out not correct.
It runs on the host alone; the benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

from benchmark.check import Compared  # noqa: E402
from benchmark.drivers.corpus import lane_offsets  # noqa: E402
from benchmark.drivers.player_read import call_span  # noqa: E402
from benchmark.gen import traffic  # noqa: E402
from benchmark.reference import decode as reference  # noqa: E402

BPF = traffic.BYTES_PER_FRAME_PCM


def _answers(cfg: dict, wl: dict, seed: int):
    """(stream, byte offset, bytes) of the answers a run of the cell
    compares: whole clips and a span of every clip of a batch, or the PCM
    of reads."""
    rng = traffic.rng_for(seed, 4)
    if wl["driver"] == "corpus":
        batches = traffic.clip_batches(cfg, wl, seed)
        clips = [s for b in batches for s in b]
        pick = rng.choice(len(clips), wl["check_clips"], replace=False)
        batch = batches[rng.integers(len(batches))]
        nbytes = wl["check_span_frames"] * BPF
        return [(clips[i], 0, clips[i].pcm_bytes) for i in pick] + [
            (s, off, nbytes) for s, off in zip(batch, lane_offsets(rng, batch, nbytes))]
    tracks = traffic.tracks(cfg, seed)
    size = cfg["read_bytes"]
    out = []
    if wl["driver"] == "player_seek":
        for _ in range(wl["check_ops"]):
            tr = tracks[rng.integers(len(tracks))]
            pos = int(rng.random() * tr.seconds * traffic.mp3gen.SAMPLE_RATE * 4) & ~3
            out.append((tr, pos, min(size, tr.pcm_bytes - pos)))
        return out
    span = call_span(cfg)
    for j in range(wl["check_reads"]):
        tr = tracks[rng.integers(len(tracks))]
        if j % 2:  # a read holding the first PCM of a decode call
            i = int(rng.integers(1, tr.pcm_bytes // span)) * span // size
        else:
            i = int(rng.integers(-(-tr.pcm_bytes // size)))
        out.append((tr, i * size, min(size, tr.pcm_bytes - i * size)))
    return out


def control(cfg: dict, wl: dict, seed: int) -> Compared:
    out = Compared(cfg["guarantee"]["limits"])
    for stream, pos, n in _answers(cfg, wl, seed):
        if pos == 0 and n == stream.pcm_bytes:
            got = reference.decode(stream.data, precision="tf32")
            want = reference.decode(stream.data)
        else:
            args = (stream.data, pos, n, stream.starts, BPF)
            got = reference.pcm_span(*args, precision="tf32")
            want = reference.pcm_span(*args)
        out.add(got, want)
    return out


def load(cell: str) -> tuple[dict, dict]:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == entry["config"])
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    return json.loads((ROOT / cfg_file).read_text()), wl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cfg, wl = load(args.workload)
    for seed in args.seeds:
        c = control(cfg, wl, seed)
        print(json.dumps({"workload": args.workload, "seed": seed, "answers": c.answers,
                          "correct": c.ok(), "compared": c.numbers()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
