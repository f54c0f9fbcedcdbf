"""Card time, the card's identity and the least time the card could take.

time_ms times a callable in card time (CUDA events, the calls queued
behind a sleep kernel); card_identity names the card as nvidia-smi gives
it; bound() is the roofline bound of a function's work from its bytes and
operations, with the operation counts of the chain's three stages
(k1_flops, k2_flops, k3_flops). chip_smoke.py and the tools share them.
"""

from __future__ import annotations

import subprocess
import time

import torch

# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at its
# 700 W limit): HBM3 bytes a second, and float32 operations a second outside
# the tensor cores (the kernels may not use TF32).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# 32-bit integer operations a second: an SM issues 64 INT32 lanes to its
# 128 FP32 lanes, half the float32 rate
INT32_OPS = FP32_FLOPS / 2


def time_ms(fn, iters: int = 20, queued: bool = True) -> float:
    """Mean milliseconds per call: CUDA events around `iters` calls after a
    warm-up call. queued: the calls are enqueued behind a sleep kernel
    long enough to hold them all, so the events time the card's work
    alone; otherwise a call whose host side (the wrapper's checks, the
    plain version's op dispatch) outlasts its card work is timed at its
    host time. The sleep doubles until it outlasts the host's enqueueing,
    up to 2^31 cycles: keep `iters` x a call's host time well under that
    (~1 s on an H100)."""
    fn()
    torch.cuda.synchronize()
    e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    cycles = 50_000_000 if queued else 0
    while True:
        e0.record()
        if cycles:
            torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        b.synchronize()
        if not queued or e0.elapsed_time(a) > host_ms or cycles >= 2**31:
            return a.elapsed_time(b) / iters
        cycles *= 2  # the sleep ended before the host had enqueued every call


def card_identity() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (its
    first line). Raises RuntimeError where nvidia-smi is absent or fails."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"nvidia-smi: {e}") from e
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    return lines[0].strip()


def device_label(dev: torch.device) -> str:
    """What a tool's result names as its device: the card's identity on
    CUDA, "cpu" on the CPU."""
    return card_identity() if dev.type == "cuda" else "cpu"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, flops: float, ops_per_s: float = FP32_FLOPS) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over their type's rate (float32 unless
    `ops_per_s` says otherwise). library_ms: no single PyTorch call
    computes any of these kernels' functions."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / ops_per_s
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_flops": flops, "library_ms": None}


def k1_flops(s_dim: int, t_dim: int) -> float:
    """K1: per line and channel, the requantize product and its sign (2)
    and the stereo matrix (2)."""
    return 4.0 * s_dim * t_dim * 2 * 576


def k2_flops(s_dim: int, t_dim: int) -> float:
    """K2, per granule and channel: 31 boundaries x 8 butterflies (6
    operations each), and per subband the IMDCT's 18 independent outputs
    of 18 multiply-adds (COS_N36's columns i and 17 - i are negatives, 18 + i
    and 35 - i equal, exactly in float32, and a fused multiply-add chain
    negated is the chain of the negated operands, bit for bit), 36 window
    multiplies and 18 overlap adds. Short blocks need fewer; K2 is bound by
    its bytes either way. Every granule of the chunk is computed, valid or
    not."""
    per_subband = 18 * 18 * 2 + 36 + 18
    return float(s_dim * t_dim * 2 * (31 * 8 * 6 + 32 * per_subband))


# v rows of the matrixing that need a sum of their own: SYNTH_N_WIN's rows
# 32 - i (i = 1..15) are the negatives of rows i, and rows 96 - i (i = 33..63)
# equal rows i, exactly in float32, so v[0..16] and v[32..48] give the rest
# by a sign or a copy, bit for bit (row 16 is ~1e-14, not 0, in float32).
SYNTH_INDEPENDENT_ROWS = 34


def k3_flops(s_dim: int, t_dim: int) -> float:
    """K3, per output row (32 samples) and channel: the matrixing's 34
    independent v values of 32 multiply-adds (SYNTH_INDEPENDENT_ROWS) and
    the 16-tap FIR of each sample (512)."""
    per_row = SYNTH_INDEPENDENT_ROWS * 32 + 32 * 16
    return float(s_dim * t_dim * 18 * 2 * per_row * 2)


def chain_flops(s_dim: int, t_dim: int) -> float:
    """K5, the chain: K1's, K2's and K3's operations."""
    return k1_flops(s_dim, t_dim) + k2_flops(s_dim, t_dim) + k3_flops(s_dim, t_dim)
