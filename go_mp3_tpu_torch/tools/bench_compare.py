"""Compare a fresh bench run with a saved baseline: value, delta,
percentage, and each detail key's baseline and current value.

    python -m go_mp3_tpu_torch.tools.bench_compare [BASELINE] [--device cuda|cpu]

Counterpart of tools/bench_compare.py, over `python -m
go_mp3_tpu_torch.bench` (run from the repo root) in place of bench.py.
BASELINE (benchmarks/baseline.json) holds a line the bench printed; save
one with `python -m go_mp3_tpu_torch.bench > benchmarks/baseline.json`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def diff(baseline: dict, current: dict) -> list[str]:
    """The comparison's lines, as tools/bench_compare.py prints them."""
    b, c = baseline["value"], current["value"]
    delta = c - b
    pct = (delta / b * 100.0) if b else float("inf")
    lines = [f"metric:   {current['metric']} ({current['unit']})",
             f"baseline: {b:.2f}",
             f"current:  {c:.2f}",
             f"delta:    {delta:+.2f} ({pct:+.1f}%)"]
    for k, v in current.get("detail", {}).items():
        lines.append(f"  {k}: {baseline.get('detail', {}).get(k)} -> {v}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", default="benchmarks/baseline.json")
    ap.add_argument("--device", default=None, help="passed on to the bench")
    args = ap.parse_args(argv)
    path = Path(args.baseline)
    if not path.exists():
        print(f"no baseline at {path}; save one with "
              f"`python -m go_mp3_tpu_torch.bench > {path}`")
        return 1
    baseline = json.loads(path.read_text())
    cmd = [sys.executable, "-m", "go_mp3_tpu_torch.bench"]
    if args.device:
        cmd += ["--device", args.device]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True, cwd=ROOT)
    current = json.loads(out.stdout.strip().splitlines()[-1])
    print("\n".join(diff(baseline, current)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
