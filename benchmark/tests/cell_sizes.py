"""Cells cut to a size the CPU can hold, for the harness's CPU tests."""

import argparse
import json

from benchmark import run as R

SIZES = {
    "fma_clips": {"catalogue_clips": 4, "batch_clips": 2, "clip_seconds": 8,
                  "pool": {"runs_per_bitrate": 2, "frames_per_run": 8},
                  "check_clips": 1},
    "gomp3_player": {"tracks": 2, "track_seconds": 6,
                     "pool": {"runs_per_bitrate": 2, "frames_per_run": 8},
                     "check_ops": 4, "check_reads": 4},
}


def bench() -> dict:
    return json.loads((R.ROOT / "BENCHMARK.json").read_text())


def run_cell(name: str, seed: int = 2 ** 31 + 7, trace: int = 0, seconds: float = 1.0,
             bench_json: dict | None = None, sizes: dict | None = None) -> dict:
    """One run of a cell on the CPU (the plain chain) at the small size, or
    with `sizes` over it."""
    b = bench_json or bench()
    cell = R.cell_of(b, name)
    args = argparse.Namespace(workload=name, seed=seed, seconds=seconds, trace=trace)
    return R.run(args, b, cell, "cpu", R.time.perf_counter(),
                 {**SIZES[cell["config"]], **(sizes or {})})
