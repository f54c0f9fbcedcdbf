"""DSP constant tables for the port's granule chain, built without JAX.

The same ISO/IEC 11172-3 data as go_mp3_tpu/ops/tables.py, computed by the
same numpy expressions so every array is bit-identical to its counterpart
there (tests/test_torch_tables.py holds them equal). The synthesis window's
numerators are the golden oracle's copy (golden/synth_window_data.py).

Only what the port's chain needs is built: the requantize power tables, the
per-line band maps (indexed
directly by the kernels and the plain version, in place of the JAX
package's one-hot expansion matrices), the band starts, the stereo and
antialias constants, the IMDCT bases and windows, the composed short-block
matrix SHORT_M3, and the synthesis tables.

Band-variant index: v = lsf * 3 + sfreq (6 variants).
Block class: 0 = long, 1 = short (non-mixed), 2 = mixed.
"""

from __future__ import annotations

import numpy as np

from ..consts import SAMPLES_PER_GR, SF_BAND_INDICES
from ..golden.synth_window_data import SYNTH_D_NUMERATORS


CLASS_LONG = 0
CLASS_SHORT = 1
CLASS_MIXED = 2
N_BAND_VARIANTS = 6

# -- requantize / stereo / antialias -----------------------------------------

# |x|^(4/3) for every int16 magnitude, and 2^(q/4) for the quarter-step
# exponents the requantizer forms (q in [POW2_QMIN, POW2_QMIN + len)), both
# rounded once from float64: the plain chain's requantize is then a product
# of two table entries, with no transcendental call whose last bits vary
# between the CPU's vector and scalar code paths.
POW_4_3_INT16 = (np.arange(32768, dtype=np.float64) ** (4.0 / 3.0)).astype(
    np.float32
)
POW2_QMIN = -640
POW2_QUARTER = np.exp2(
    np.arange(POW2_QMIN, 129, dtype=np.float64) / 4.0
).astype(np.float32)

PRETAB = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0],
    dtype=np.float64,
)

_IS_RATIOS = np.array(
    [0.000000, 0.267949, 0.577350, 1.000000, 1.732051, 3.732051],
    dtype=np.float32,
)
# per is_pos 0..6: left/right multipliers (6 is the tan(pi/2) case)
IS_RATIO_L = np.empty(7, dtype=np.float32)
IS_RATIO_R = np.empty(7, dtype=np.float32)
IS_RATIO_L[:6] = _IS_RATIOS / (np.float32(1.0) + _IS_RATIOS)
IS_RATIO_R[:6] = np.float32(1.0) / (np.float32(1.0) + _IS_RATIOS)
IS_RATIO_L[6] = 1.0
IS_RATIO_R[6] = 0.0

INV_SQRT2 = np.float32(np.sqrt(2.0) / 2.0)

CS = np.array(
    [0.857493, 0.881742, 0.949629, 0.983315, 0.995518, 0.999161, 0.999899,
     0.999993],
    dtype=np.float32,
)
CA = np.array(
    [-0.514496, -0.471732, -0.313377, -0.181913, -0.094574, -0.040966,
     -0.014199, -0.003700],
    dtype=np.float32,
)

# -- IMDCT --------------------------------------------------------------------


def _imdct_windows() -> np.ndarray:
    """The four window shapes [block_type][36]."""
    w = np.zeros((4, 36), dtype=np.float64)
    n = np.arange(36)
    w[0] = np.sin(np.pi / 36 * (n + 0.5))
    w[1, :18] = np.sin(np.pi / 36 * (n[:18] + 0.5))
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(np.pi / 12 * (n[24:30] + 0.5 - 18.0))
    w[1, 30:] = 0.0
    w[2, :12] = np.sin(np.pi / 12 * (n[:12] + 0.5))
    w[2, 12:] = 0.0
    w[3, :6] = 0.0
    w[3, 6:12] = np.sin(np.pi / 12 * (n[6:12] + 0.5 - 6.0))
    w[3, 12:18] = 1.0
    w[3, 18:] = np.sin(np.pi / 36 * (n[18:] + 0.5))
    return w.astype(np.float32)


IMDCT_WIN = _imdct_windows()

_i12, _j12 = np.meshgrid(np.arange(6), np.arange(12), indexing="ij")
COS_N12 = np.cos(np.pi / 24 * (2 * _j12 + 1 + 6) * (2 * _i12 + 1)).astype(
    np.float32
)  # [6, 12]
_i36, _j36 = np.meshgrid(np.arange(18), np.arange(36), indexing="ij")
COS_N36 = np.cos(np.pi / 72 * (2 * _j36 + 1 + 18) * (2 * _i36 + 1)).astype(
    np.float32
)  # [18, 36]

# Short-block IMDCT as one [18, 36] matrix (go_mp3_tpu/ops/granule.py:173-193):
# the 12-point cosines, the short window and the three overlapping sub-block
# placements composed, M3[3m + i, 6 + 6i + p] = COS_N12[m, p] * win_short[p].
# Folding the window into the constant (rather than multiplying the data
# afterwards) is what the JAX chain does; keeping it keeps short-block
# output within rounding of JAX's.
SHORT_M3 = np.zeros((18, 36), np.float32)
for _m in range(6):
    for _i in range(3):
        for _p in range(12):
            SHORT_M3[3 * _m + _i, 6 + 6 * _i + _p] = (
                COS_N12[_m, _p] * IMDCT_WIN[2, _p]
            )

# -- polyphase synthesis -------------------------------------------------------

_i64, _j32 = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
SYNTH_N_WIN = np.cos((16 + _i64) * (2 * _j32 + 1) * (np.pi / 64.0)).astype(
    np.float32
)  # [64, 32]

SYNTH_DTBL = (
    np.array(SYNTH_D_NUMERATORS, dtype=np.float64) / 65536.0
).astype(np.float32)  # [512]

FREQ_INV_SIGN = np.ones((32, 18), dtype=np.float32)
FREQ_INV_SIGN[1::2, 1::2] = -1.0

# -- per-line band maps ----------------------------------------------------------


def _long_sfb_of_line(long_bands) -> np.ndarray:
    out = np.zeros(SAMPLES_PER_GR, dtype=np.int32)
    for sfb in range(22):
        out[long_bands[sfb]:long_bands[sfb + 1]] = sfb
    return out


def _short_maps(short_bands) -> tuple[np.ndarray, np.ndarray]:
    """line -> (short band, window) in the win-major layout."""
    sfb_map = np.zeros(SAMPLES_PER_GR, dtype=np.int32)
    win_map = np.zeros(SAMPLES_PER_GR, dtype=np.int32)
    for sfb in range(13):
        start3 = 3 * short_bands[sfb]
        win_len = short_bands[sfb + 1] - short_bands[sfb]
        for win in range(3):
            for j in range(win_len):
                line = start3 + win * win_len + j
                sfb_map[line] = sfb
                win_map[line] = win
    return sfb_map, win_map


def _reorder_perm(short_bands, mixed: bool) -> np.ndarray:
    """x_reordered[i] = x[perm[i]]: win-major -> interleaved within each
    short band (mixed blocks keep the first three bands in place)."""
    perm = np.arange(SAMPLES_PER_GR, dtype=np.int32)
    for sfb in range(3 if mixed else 0, 13):
        start3 = 3 * short_bands[sfb]
        win_len = short_bands[sfb + 1] - short_bands[sfb]
        for win in range(3):
            for j in range(win_len):
                perm[start3 + j * 3 + win] = start3 + win * win_len + j
    return perm


_shape = (N_BAND_VARIANTS, SAMPLES_PER_GR)
LONG_SFB_OF_LINE = np.zeros(_shape, dtype=np.int32)
SHORT_SFB_OF_LINE = np.zeros(_shape, dtype=np.int32)
SHORT_WIN_OF_LINE = np.zeros(_shape, dtype=np.int32)
REORDER_PERM_SHORT = np.zeros(_shape, dtype=np.int32)
REORDER_PERM_MIXED = np.zeros(_shape, dtype=np.int32)
LONG_BAND_START = np.zeros((N_BAND_VARIANTS, 23), dtype=np.int32)
SHORT_BAND_START3 = np.zeros((N_BAND_VARIANTS, 14), dtype=np.int32)
for _lsf in range(2):
    for _sfreq in range(3):
        _v = _lsf * 3 + _sfreq
        _long, _short = SF_BAND_INDICES[_lsf][_sfreq][:2]
        LONG_SFB_OF_LINE[_v] = _long_sfb_of_line(_long)
        SHORT_SFB_OF_LINE[_v], SHORT_WIN_OF_LINE[_v] = _short_maps(_short)
        REORDER_PERM_SHORT[_v] = _reorder_perm(_short, mixed=False)
        REORDER_PERM_MIXED[_v] = _reorder_perm(_short, mixed=True)
        LONG_BAND_START[_v] = np.asarray(_long, dtype=np.int32)
        SHORT_BAND_START3[_v] = 3 * np.asarray(_short, dtype=np.int32)

# The chain receives spectra already reordered (the parser applies
# REORDER_PERM_*), so the requantize short maps are composed with the
# permutation: post-reorder line l was win-major line perm[l].
REQ_SHORT_SFB_OF_LINE = np.take_along_axis(
    SHORT_SFB_OF_LINE, REORDER_PERM_SHORT, axis=1
)
REQ_SHORT_WIN_OF_LINE = np.take_along_axis(
    SHORT_WIN_OF_LINE, REORDER_PERM_SHORT, axis=1
)


def block_class(win_switch: int, block_type: int, mixed: int) -> int:
    if win_switch == 1 and block_type == 2:
        return CLASS_MIXED if mixed else CLASS_SHORT
    return CLASS_LONG
