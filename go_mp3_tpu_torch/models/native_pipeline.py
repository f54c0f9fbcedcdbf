"""Native-parser -> GranuleBatch packing, with vectorised numpy.

Counterpart of go_mp3_tpu/models/native_pipeline.py: the C++ parser's
arrays (spectra, scalefactors, meta words) sliced straight into the port's
GranuleBatch fields, with no Python work per granule.
"""

from __future__ import annotations

import numpy as np

from ..native import lib as native

from ..ops.granule import GranuleBatch, granule_batch_from_numpy


def granule_batch_from_native(
    spectra: np.ndarray,
    sfl: np.ndarray,
    sfs: np.ndarray,
    meta: np.ndarray,
    pad_to: int | None = None,
) -> tuple[GranuleBatch, int]:
    """Native parser arrays of n granules -> (GranuleBatch of CPU tensors
    [1, T, ...], zero-padded to T = `pad_to`, n)."""
    n = spectra.shape[0]
    t_dim = pad_to if pad_to is not None else n
    if t_dim < n:
        raise ValueError(f"pad_to {t_dim} < {n} granules")

    def pad(a: np.ndarray) -> np.ndarray:
        out = np.zeros((t_dim, *a.shape[1:]), dtype=a.dtype)
        out[:n] = a
        return out

    def pair(start: int) -> np.ndarray:
        return meta[:, start : start + 2]

    flags = meta[:, native.META_FLAGS]
    fields = (
        spectra,
        sfl,
        sfs.reshape(n, 2, 13, 3),
        pair(native.META_GLOBAL_GAIN),
        pair(native.META_SF_SCALE),
        pair(native.META_PREFLAG),
        meta[:, native.META_SUBBLOCK_GAIN : native.META_SUBBLOCK_GAIN + 6].reshape(n, 2, 3),
        pair(native.META_BLOCK_TYPE),
        pair(native.META_BLOCK_CLASS),
        meta[:, native.META_VARIANT],
        (flags & 1).astype(bool),
        ((flags >> 1) & 1).astype(bool),
        meta[:, native.META_COUNT1_R],
        ((flags >> 2) & 1).astype(bool),
    )
    return granule_batch_from_numpy([pad(a) for a in fields], "cpu"), n


def parse_stream_native(data: bytes):
    """Parse a whole stream with the native parser; returns the raw arrays
    (spectra, sfl, sfs, meta) plus the sample rate."""
    p = native.NativeParser(data)
    try:
        return p.parse_all(), p.sample_rate
    finally:
        p.close()
