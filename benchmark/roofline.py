"""The least time of the granule chain's work on one H100, whatever kernel does it.

The work is counted from the generated streams, per valid granule and
channel (padding is never work), with the operations of published fast
algorithms for each stage, so that a kernel built on any of them reads at
most 100%:

 - requantization, ISO/IEC 11172-3 2.4.3.4.7: with |is|^(4/3) from a table
   and one gain per band, 1 multiplication per nonzero line;
 - MS stereo, 2.4.3.4.9.2: the 1/sqrt(2) folded into the gains, 1 addition
   per line and channel up to the granule's last nonzero line;
 - antialias, 2.4.3.4.10: 8 butterflies per subband boundary (31 in a long
   block, 1 in a mixed block, none in a short block), 4 multiplications and
   2 additions each;
 - IMDCT (Duhamel, Mahieux, Petit, ICASSP 1991: an N-point IMDCT as an
   N/4-point complex FFT between pre- and post-twiddles, each twiddle 3
   multiplications and 3 additions): the 18-point DCT-IV of a long block
   is 9 + 9 twiddles (108) and a 9-point complex FFT of six 3-point
   Winograd DFTs (16 each) and 4 inner twiddles (24), 228 in all, then 36
   window multiplications and 18 overlap additions: 282 per subband; a
   short block's three 6-point DCT-IVs (3 + 3 twiddles and one 3-point DFT,
   52 each), 36 window multiplications, 12 additions where the windows
   overlap and 18 overlap additions: 222 per subband;
 - polyphase matrixing as a 32-point DCT (Konstantinides, IEEE Signal
   Processing Letters 1(2), 1994) by Lee's algorithm (B. G. Lee, IEEE
   ASSP 32(6), 1984): 80 multiplications and 209 additions per time slot,
   18 slots per granule;
 - the synthesis window, 2.4.3.2.2: 16 products and 15 additions per PCM
   sample.

Bytes: each granule's main data (its part2_3_length bits) read once and its
int16 PCM written once. Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s
float32 outside the tensor cores and 3.35 TB/s of HBM3, at a power limit
of 700 W (the run prints the card's limit beside the share).
"""

from __future__ import annotations

import numpy as np

PEAK_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

IMDCT_LONG = 282
IMDCT_SHORT = 222
MATRIX_SLOT = 80 + 209
FIR_SAMPLE = 16 + 15
ANTIALIAS_BOUNDARY = 8 * 6


def granule_ops(is_: np.ndarray, short: np.ndarray, mixed: np.ndarray,
                ms: np.ndarray) -> np.ndarray:
    """Operations of each granule and channel: is_ [G, C, 576] quantized
    lines; short, mixed [G, C] block flags (mixed implies short); ms [G]."""
    nz = is_ != 0
    requant = nz.sum(-1)
    rev = nz.any(1)[:, ::-1]
    last = np.where(rev.any(1), 576 - rev.argmax(1), 0)  # lines up to the last nonzero
    stereo = np.where(ms, last, 0)[:, None] * np.ones(is_.shape[1], np.int64)
    boundaries = np.where(short, np.where(mixed, 1, 0), 31)
    long_subbands = np.where(short, np.where(mixed, 2, 0), 32)
    imdct = long_subbands * IMDCT_LONG + (32 - long_subbands) * IMDCT_SHORT
    fixed = 18 * MATRIX_SLOT + 576 * FIR_SAMPLE
    return requant + stereo + boundaries * ANTIALIAS_BOUNDARY + imdct + fixed


def granule_bytes(part23_bits: np.ndarray) -> np.ndarray:
    """Bytes of each granule and channel: its main data in, its PCM out."""
    return part23_bits / 8.0 + 576 * 2


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_S)
