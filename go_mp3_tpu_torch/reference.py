"""What the port is held against, reached without jax.

 - the exact backend (the port's own Decoder(backend="exact")): the C++
   parser plus the C++ DSP that replicates the reference decoder's float32
   operation order, with no device;
 - the ISO/IEC 11172-4 compliance measure between two s16le PCM streams
   (thresholds as in tools/compliance.py and conformance/REPORT.json);
 - the C++ stream index (frame starts, bytes per frame, sample rate), which
   builds rotated multi-lane corpora the way bench.py does.
"""

from __future__ import annotations

import numpy as np

from .decoder import Decoder

# native_available(): the C++ parser and exact DSP (libmp3parse.so, built
# with g++ at first use) are loaded; index_stream(data): (frame start
# offsets, bytes per frame, sample rate) of a stream
from .native.lib import available as native_available  # noqa: F401
from .native.lib import index_stream  # noqa: F401

# ISO/IEC 11172-4 thresholds in 16-bit LSBs: full and limited accuracy
FULL_RMS = 0.289  # 2^-15 / sqrt(12) * 32768
FULL_MAXDIFF = 2  # 2^-14 * 32768
LIMITED_RMS = 4.62  # 2^-11 / sqrt(12) * 32768
LIMITED_MAXDIFF = 32  # 2^-10 * 32768


def iso_metrics(a: bytes, b: bytes) -> tuple[float, int]:
    """(RMS, max |difference|) in 16-bit LSBs over sample-aligned PCM of
    equal length."""
    if len(a) != len(b):
        raise ValueError(f"PCM lengths differ: {len(a)} vs {len(b)}")
    if not a:
        return 0.0, 0
    d = np.frombuffer(a, "<i2").astype(np.int32) - np.frombuffer(b, "<i2")
    return float(np.sqrt(np.mean(d.astype(np.float64) ** 2))), int(np.abs(d).max())


def exact_decoder(data: bytes) -> Decoder:
    """A Decoder on the exact backend (no device)."""
    return Decoder(data, backend="exact")


def decode_exact(data: bytes) -> bytes:
    return exact_decoder(data).read_all()
