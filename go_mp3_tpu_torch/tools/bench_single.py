"""Single-stream decode benchmark on the port (tools/bench_single.py's
counterpart): MB/s of compressed input and x realtime per backend, the
reference harness's BenchmarkDecode/{small,large} metric.

    python -m go_mp3_tpu_torch.tools.bench_single [--backend exact|device|golden|all]
        [--device cuda|cpu]

Fixtures, from this checkout: small = conformance/synthetic_escape.mp3 x75
(23.5 s of audio), large = the same x300 (94.04 s; chip_smoke.py phase 4's
stream). Each is parsed for real (frame boundaries align). The device
backend runs on --device (the card unless the caller asks for the CPU);
exact and golden run on the host. golden (numpy float64) runs on small
only, one rep. Prints one JSON line per (fixture, backend); `device` names
where that row's decode ran: the card's name and power limit, or "cpu".
"""

from __future__ import annotations

import argparse
import json
import time

from ..decoder import Decoder
from ..device import resolve_device
from .cardtime import device_label
from .corpus import ESCAPE

FIXTURES = {"small": 75, "large": 300}  # copies of synthetic_escape.mp3
BACKENDS = ("exact", "device", "golden")


def run_one(data: bytes, backend: str, reps: int, device=None) -> dict:
    """Best over 3 rounds of `reps` whole decodes (Decoder(...).read_all()).
    For the device backend on CUDA each decode ends with its PCM on the
    host, so the host clock covers the card's work."""
    dev = resolve_device(device) if backend == "device" else None
    best, pcm = float("inf"), b""
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            pcm = Decoder(data, backend=backend, device=dev).read_all()
        best = min(best, (time.perf_counter() - t0) / reps)
    sr = Decoder(data, backend=backend, device=dev).sample_rate()
    audio_s = len(pcm) / 4 / sr
    return {
        "backend": backend,
        "compressed_mb_s": round(len(data) / 1e6 / best, 2),
        "x_realtime": round(audio_s / best, 1),
        "ms_per_file": round(best * 1000, 1),
        "bytes_in": len(data),
        "bytes_out": len(pcm),
        "device": device_label(dev) if dev is not None else "cpu",
    }


def rows(fixtures=tuple(FIXTURES), backends=BACKENDS, device=None, reps=None):
    """One result per (fixture, backend), fixture-major. reps=None: the
    harness's own (8 on small, 4 on large; golden 1, and on small only)."""
    base = ESCAPE.read_bytes()
    out = []
    for name in fixtures:
        data = base * FIXTURES[name]
        for b in backends:
            if b == "golden" and name != "small":
                continue
            n = reps or (1 if b == "golden" else 4 if name == "large" else 8)
            out.append({**run_one(data, b, n, device), "fixture": name})
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.tools.bench_single",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="all", choices=BACKENDS + ("all",))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device backend runs (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA unless --device cpu
    backends = BACKENDS if args.backend == "all" else (args.backend,)
    for r in rows(backends=backends, device=dev):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
