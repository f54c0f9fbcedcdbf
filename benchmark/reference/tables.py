# Frozen copy of go_mp3_tpu_torch/golden/tables.py at commit 6b659fa, its imports made local.
# sha256 of the original without its relative imports: 8e1057e9b87772d448f73496bb251db21905d9a5d3b707f0ab285a1749283d42
"""DSP constant tables and per-line index maps for the granule chain.

All tables are ISO/IEC 11172-3 spec data, computed or tabulated the same way
as the reference decoder builds them at init:
 - pow-4/3 requantization LUT (frame.go:32-40),
 - pretab / intensity-stereo ratios / antialias cs,ca (frame.go:33,305,422-425),
 - IMDCT cosine matrices + 4 window shapes (imdct.go:21-79),
 - polyphase matrixing cosines + the 512-tap synthesis window
   (frame.go:488-497, 499-628),
plus precomputed per-line scalefactor-band maps and short-block reorder
permutations that turn the reference's data-dependent loops
(frame.go:184-302) into static gathers, which is what the TPU path needs.

Band-variant index: v = lsf * 3 + sfreq  (6 variants).
Block class: 0 = long, 1 = short (non-mixed), 2 = mixed.
"""

from __future__ import annotations

import numpy as np

from .consts import SAMPLES_PER_GR, SF_BAND_INDICES
from .synth_window_data import SYNTH_D_NUMERATORS

# ---------------------------------------------------------------------------
# Requantization
# ---------------------------------------------------------------------------

# |x|^(4/3) for |x| in [0, 8206]; float64 like the reference's powtab34.
POW_4_3_F64 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)
POW_4_3_F32 = POW_4_3_F64.astype(np.float32)

PRETAB = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0],
    dtype=np.float64,
)

# ---------------------------------------------------------------------------
# Stereo
# ---------------------------------------------------------------------------

# tan(k*pi/12) for k=0..5 (ISO intensity-stereo ratios; frame.go:305)
IS_RATIOS = np.array(
    [0.000000, 0.267949, 0.577350, 1.000000, 1.732051, 3.732051],
    dtype=np.float32,
)

# Per is_pos in 0..6: left/right channel multipliers. is_pos == 6 is the
# tan(pi/2) special case (1, 0); is_pos >= 7 disables intensity processing.
IS_RATIO_L = np.empty(7, dtype=np.float32)
IS_RATIO_R = np.empty(7, dtype=np.float32)
IS_RATIO_L[:6] = IS_RATIOS / (np.float32(1.0) + IS_RATIOS)
IS_RATIO_R[:6] = np.float32(1.0) / (np.float32(1.0) + IS_RATIOS)
IS_RATIO_L[6] = 1.0
IS_RATIO_R[6] = 0.0

INV_SQRT2 = np.float32(np.sqrt(2.0) / 2.0)

# ---------------------------------------------------------------------------
# Antialias butterflies (ISO Table B.9 ci coefficients, normalized)
# ---------------------------------------------------------------------------

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

# ---------------------------------------------------------------------------
# IMDCT (hybrid filterbank)
# ---------------------------------------------------------------------------


def _imdct_windows() -> np.ndarray:
    """The four window shapes [block_type][36] (imdct.go:23-57)."""
    w = np.zeros((4, 36), dtype=np.float64)
    n = np.arange(36)
    # 0: normal (long) window
    w[0] = np.sin(np.pi / 36 * (n + 0.5))
    # 1: start window
    w[1, :18] = np.sin(np.pi / 36 * (n[:18] + 0.5))
    w[1, 18:24] = 1.0
    w[1, 24:30] = np.sin(np.pi / 12 * (n[24:30] + 0.5 - 18.0))
    w[1, 30:] = 0.0
    # 2: short window (applied to each 12-sample sub-block)
    w[2, :12] = np.sin(np.pi / 12 * (n[:12] + 0.5))
    w[2, 12:] = 0.0
    # 3: stop window
    w[3, :6] = 0.0
    w[3, 6:12] = np.sin(np.pi / 12 * (n[6:12] + 0.5 - 6.0))
    w[3, 12:18] = 1.0
    w[3, 18:] = np.sin(np.pi / 36 * (n[18:] + 0.5))
    return w.astype(np.float32)


IMDCT_WIN = _imdct_windows()

# cos(pi/2N * (2j + 1 + N/2) * (2i + 1)), the IMDCT bases (imdct.go:59-79)
_i12, _j12 = np.meshgrid(np.arange(6), np.arange(12), indexing="ij")
COS_N12 = np.cos(np.pi / 24 * (2 * _j12 + 1 + 6) * (2 * _i12 + 1)).astype(
    np.float32
)  # [6, 12]
_i36, _j36 = np.meshgrid(np.arange(18), np.arange(36), indexing="ij")
COS_N36 = np.cos(np.pi / 72 * (2 * _j36 + 1 + 18) * (2 * _i36 + 1)).astype(
    np.float32
)  # [18, 36]

# ---------------------------------------------------------------------------
# Polyphase synthesis filterbank
# ---------------------------------------------------------------------------

# N[i][j] = cos((16+i)(2j+1) pi/64), i in 0..63, j in 0..31 (frame.go:490-497)
_i64, _j32 = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
SYNTH_N_WIN = np.cos((16 + _i64) * (2 * _j32 + 1) * (np.pi / 64.0)).astype(
    np.float32
)  # [64, 32]

# ISO Table B.3 synthesis window D[512] (exact 2^-16 multiples)
SYNTH_DTBL = (
    np.array(SYNTH_D_NUMERATORS, dtype=np.float64) / 65536.0
).astype(np.float32)

# Frequency-inversion sign mask [32, 18]: odd subband x odd sample -> -1
FREQ_INV_SIGN = np.ones((32, 18), dtype=np.float32)
FREQ_INV_SIGN[1::2, 1::2] = -1.0

# ---------------------------------------------------------------------------
# Per-line scalefactor-band maps and reorder permutations
# ---------------------------------------------------------------------------

N_BAND_VARIANTS = 6  # lsf * 3 + sfreq


def _long_sfb_of_line(long_bands) -> np.ndarray:
    """Map line index -> long scalefactor band (22 bands)."""
    out = np.zeros(SAMPLES_PER_GR, dtype=np.int32)
    for sfb in range(22):
        out[long_bands[sfb]:long_bands[sfb + 1]] = sfb
    return out


def _short_maps(short_bands) -> tuple[np.ndarray, np.ndarray]:
    """Map line index -> (short band, window) for the win-major layout the
    Huffman data arrives in (requantize order, frame.go:215-241)."""
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
    """Permutation p with x_reordered[i] = x[p[i]] for short blocks
    (frame.go:257-302): within each short band, win-major (win, j) layout
    becomes interleaved (j, win). Mixed blocks keep lines < 36 in place."""
    perm = np.arange(SAMPLES_PER_GR, dtype=np.int32)
    first_sfb = 3 if mixed else 0
    for sfb in range(first_sfb, 13):
        start3 = 3 * short_bands[sfb]
        win_len = short_bands[sfb + 1] - short_bands[sfb]
        for win in range(3):
            for j in range(win_len):
                src = start3 + win * win_len + j
                dst = start3 + j * 3 + win
                perm[dst] = src
    return perm


# [variant][576] arrays
LONG_SFB_OF_LINE = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), dtype=np.int32)
SHORT_SFB_OF_LINE = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), dtype=np.int32)
SHORT_WIN_OF_LINE = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), dtype=np.int32)
REORDER_PERM_SHORT = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), dtype=np.int32)
REORDER_PERM_MIXED = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), dtype=np.int32)
# Band start line per long sfb [variant][22] and per short sfb*3 [variant][13]
LONG_BAND_START = np.zeros((N_BAND_VARIANTS, 23), dtype=np.int32)
SHORT_BAND_START3 = np.zeros((N_BAND_VARIANTS, 14), dtype=np.int32)

for _lsf in range(2):
    for _sfreq in range(3):
        v = _lsf * 3 + _sfreq
        long_bands = SF_BAND_INDICES[_lsf][_sfreq][0]
        short_bands = SF_BAND_INDICES[_lsf][_sfreq][1]
        LONG_SFB_OF_LINE[v] = _long_sfb_of_line(long_bands)
        s_map, w_map = _short_maps(short_bands)
        SHORT_SFB_OF_LINE[v] = s_map
        SHORT_WIN_OF_LINE[v] = w_map
        REORDER_PERM_SHORT[v] = _reorder_perm(short_bands, mixed=False)
        REORDER_PERM_MIXED[v] = _reorder_perm(short_bands, mixed=True)
        LONG_BAND_START[v] = np.asarray(long_bands, dtype=np.int32)
        SHORT_BAND_START3[v] = 3 * np.asarray(short_bands, dtype=np.int32)

# ---------------------------------------------------------------------------
# Gather-free device formulation: post-reorder band maps + one-hot expansion
# ---------------------------------------------------------------------------
# The device path receives spectra ALREADY in reordered (interleaved) layout
# (the host applies REORDER_PERM_SHORT after Huffman decode — a trivial int
# shuffle there, a 9M-element gather avoided on TPU). Requantization maps are
# therefore composed with the permutation: line l was source line perm[l].
#
# For mixed blocks, lines < 36 take the long path (masked elementwise), where
# perm differs from the pure-short perm — but those lines use the long maps,
# which are permutation-independent, so one composed short map serves both.

REQ_SHORT_SFB_OF_LINE = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), np.int32)
REQ_SHORT_WIN_OF_LINE = np.zeros((N_BAND_VARIANTS, SAMPLES_PER_GR), np.int32)
for _v in range(N_BAND_VARIANTS):
    perm = REORDER_PERM_SHORT[_v]
    REQ_SHORT_SFB_OF_LINE[_v] = SHORT_SFB_OF_LINE[_v][perm]
    REQ_SHORT_WIN_OF_LINE[_v] = SHORT_WIN_OF_LINE[_v][perm]

# One-hot expansion matrices: per-band values -> per-line values as a matmul.
# Rows are (variant, band) pairs; a granule writes its per-band values into
# its variant's block (masked broadcast), zeros elsewhere, and one matmul
# broadcasts them onto lines.
#   E_LONG  [6*22, 576]  : row (v, sfb)        -> lines of long band sfb
#   E_SHORT [6*39, 576]  : row (v, sfb*3+win)  -> post-reorder-map lines,
#                          using the REQUANTIZE (composed) short maps
#   E_SHORT_IS [6*39, 576]: same but with the INTENSITY maps (win-major
#                          positions, frame.go:342 — the reference indexes
#                          the reordered data win-major there)
E_LONG = np.zeros((N_BAND_VARIANTS * 22, SAMPLES_PER_GR), np.float32)
E_SHORT = np.zeros((N_BAND_VARIANTS * 39, SAMPLES_PER_GR), np.float32)
E_SHORT_IS = np.zeros((N_BAND_VARIANTS * 39, SAMPLES_PER_GR), np.float32)
for _v in range(N_BAND_VARIANTS):
    for l in range(SAMPLES_PER_GR):
        E_LONG[_v * 22 + LONG_SFB_OF_LINE[_v][l], l] = 1.0
        E_SHORT[
            _v * 39 + REQ_SHORT_SFB_OF_LINE[_v][l] * 3 + REQ_SHORT_WIN_OF_LINE[_v][l],
            l,
        ] = 1.0
        E_SHORT_IS[
            _v * 39 + SHORT_SFB_OF_LINE[_v][l] * 3 + SHORT_WIN_OF_LINE[_v][l],
            l,
        ] = 1.0

# Block classes
CLASS_LONG = 0
CLASS_SHORT = 1
CLASS_MIXED = 2


def block_class(win_switch: int, block_type: int, mixed: int) -> int:
    if win_switch == 1 and block_type == 2:
        return CLASS_MIXED if mixed else CLASS_SHORT
    return CLASS_LONG
