"""Device selection for the port: CUDA unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means CUDA, and raises where CUDA is unavailable: the port never
    picks the CPU on its own. Pins full-FP32 matmuls (no TF32), mirroring the
    HIGHEST-precision rules of go_mp3_tpu/ops/granule.py:44-74."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch chain on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev
