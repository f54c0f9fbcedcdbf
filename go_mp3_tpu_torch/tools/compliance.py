"""ISO/IEC 11172-4 compliance harness on the port (tools/compliance.py's
counterpart).

    python -m go_mp3_tpu_torch.tools.compliance FILE [--backend device]
        [--oracle-backend exact | --oracle-cmd "mpg123 -e s16 --stereo -s -q"]
        [--device cuda|cpu] [--json]

Decodes FILE with one of the port's backends (device on --device, exact,
golden), decodes it again with an oracle (another backend, or an external
decoder command writing s16le stereo PCM to stdout, the file path
appended), finds the best sample alignment by the reference's two-phase
coarse/fine RMS search over +-3000 stereo samples (encoder-delay
handling), then reports RMS and max difference against the ISO thresholds
and the top-10 histogram of the differences.

Exit status: 0 full compliance, 1 limited compliance, 2 fail.
"""

from __future__ import annotations

import argparse
import json
import shlex
import subprocess
import sys

import numpy as np

from ..decoder import Decoder
from ..device import resolve_device
from ..reference import FULL_MAXDIFF, FULL_RMS, LIMITED_MAXDIFF, LIMITED_RMS
from .cardtime import device_label

MAX_OFFSET = 3000  # stereo samples searched


def decode_with_backend(data: bytes, backend: str, device=None) -> bytes:
    """`device` is where the device backend runs (None: CUDA, raising where
    there is none); exact and golden run on the host."""
    return Decoder(data, backend=backend, device=device).read_all()


def decode_with_command(path: str, cmd: str) -> bytes:
    """Run an external decoder command; it must write s16le stereo PCM to
    stdout (the file path is appended, mpg123-style)."""
    proc = subprocess.run(shlex.split(cmd) + [path], capture_output=True, check=True)
    return proc.stdout


def _stereo(pcm: bytes) -> np.ndarray:
    """PCM bytes -> int32 array [n_stereo_frames, 2]."""
    a = np.frombuffer(pcm, "<i2")
    return a[: len(a) // 2 * 2].reshape(-1, 2).astype(np.int32)


def _aligned(ref: np.ndarray, test: np.ndarray, offset: int):
    """(ref, test) with test shifted by `offset` stereo samples, cut to
    their common length."""
    r, t = (ref, test[offset:]) if offset >= 0 else (ref[-offset:], test)
    n = min(len(r), len(t))
    return r[:n], t[:n]


def _rms_at_offset(ref: np.ndarray, test: np.ndarray, offset: int,
                   sample_step: int) -> float:
    r, t = _aligned(ref, test, offset)
    if len(r) <= 0:
        return float("inf")
    d = (t[::sample_step] - r[::sample_step]).astype(np.float64)
    return float(np.sqrt(np.mean(d * d)))


def find_best_alignment(ref: np.ndarray, test: np.ndarray,
                        max_offset: int = MAX_OFFSET) -> int:
    """Two-phase search: every 50th offset on every 100th sample, then
    every offset within 50 of the best on every 10th sample."""
    best_rms, best_offset = float("inf"), 0
    for offset in range(-max_offset, max_offset + 1, 50):
        rms = _rms_at_offset(ref, test, offset, 100)
        if rms < best_rms:
            best_rms, best_offset = rms, offset
    lo = max(-max_offset, best_offset - 50)
    hi = min(max_offset, best_offset + 50)
    for offset in range(lo, hi + 1):
        rms = _rms_at_offset(ref, test, offset, 10)
        if rms < best_rms:
            best_rms, best_offset = rms, offset
    return best_offset


def compare(ref: np.ndarray, test: np.ndarray, offset: int) -> dict:
    """Full-resolution comparison at `offset` and the verdict."""
    r, t = _aligned(ref, test, offset)
    if len(r) <= 0:
        return {"total_samples": 0, "full": False, "limited": False}
    d = (t - r).reshape(-1)  # interleaved L,R diffs
    absd = np.abs(d)
    max_at = int(absd.argmax())
    rms = float(np.sqrt(np.mean(d.astype(np.float64) ** 2)))
    max_diff = int(absd[max_at])
    vals, counts = np.unique(d, return_counts=True)
    order = np.argsort(-counts)[:10]
    hist = [{"diff": int(vals[i]), "count": int(counts[i]),
             "pct": round(100.0 * counts[i] / d.size, 2)} for i in order]
    return {
        "total_samples": int(d.size),
        "offset": offset,
        "rms": rms,
        "max_diff": max_diff,
        "max_diff_at": max_at,
        "mean_diff": float(d.mean()),
        "full": rms < FULL_RMS and max_diff <= FULL_MAXDIFF,
        "limited": rms < LIMITED_RMS and max_diff <= LIMITED_MAXDIFF,
        "histogram_top10": hist,
    }


def run(path: str, backend: str, oracle_backend: str | None,
        oracle_cmd: str | None, device=None) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    test = _stereo(decode_with_backend(data, backend, device))
    if oracle_cmd:
        oracle_name = oracle_cmd
        ref = _stereo(decode_with_command(path, oracle_cmd))
    else:
        oracle_name = f"backend:{oracle_backend}"
        ref = _stereo(decode_with_backend(data, oracle_backend, device))
    offset = find_best_alignment(ref, test)
    result = compare(ref, test, offset)
    result["file"] = path
    result["decoder"] = f"backend:{backend}"
    result["oracle"] = oracle_name
    # where the device backend ran; exact, golden and a command run on the host
    on_device = "device" in (backend, None if oracle_cmd else oracle_backend)
    result["device"] = device_label(resolve_device(device)) if on_device else "cpu"
    result["verdict"] = ("FULL COMPLIANCE" if result["full"]
                         else "LIMITED COMPLIANCE" if result["limited"] else "FAIL")
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.tools.compliance",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("file")
    ap.add_argument("--backend", default="device",
                    help="backend under test (device/exact/golden)")
    ap.add_argument("--oracle-backend", default="golden",
                    help="oracle backend when no --oracle-cmd is given")
    ap.add_argument("--oracle-cmd", default=None,
                    help="external decoder command writing s16le stereo PCM "
                         "to stdout (file path appended), e.g. "
                         "'mpg123 -e s16 --stereo -s -q'")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the device backend runs (default cuda)")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)

    result = run(args.file, args.backend, args.oracle_backend, args.oracle_cmd,
                 args.device)
    if args.json:
        print(json.dumps(result))
    else:
        print(f"file:        {result['file']}")
        print(f"decoder:     {result['decoder']}")
        print(f"device:      {result['device']}")
        print(f"oracle:      {result['oracle']}")
        print(f"alignment:   {result.get('offset', 0)} stereo samples")
        print(f"samples:     {result['total_samples']}")
        if result["total_samples"]:
            print(f"RMS:         {result['rms']:.6f} LSB "
                  f"(full < {FULL_RMS}, limited < {LIMITED_RMS})")
            print(f"max diff:    {result['max_diff']} at sample "
                  f"{result['max_diff_at']} "
                  f"(full <= {FULL_MAXDIFF}, limited <= {LIMITED_MAXDIFF})")
            print(f"mean diff:   {result['mean_diff']:.6f}")
            print("diff histogram (top 10):")
            for h in result["histogram_top10"]:
                print(f"  diff={h['diff']:>4}: {h['count']} samples ({h['pct']}%)")
        print(f"verdict:     {result['verdict']}")
    return 0 if result["full"] else 1 if result["limited"] else 2


if __name__ == "__main__":
    sys.exit(main())
