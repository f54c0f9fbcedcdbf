# Frozen copy of go_mp3_tpu_torch/golden/reference_dsp.py at commit 6b659fa, its imports made local.
# sha256 of the original without its relative imports: 74d21c1a0910c3edf5e8f95b68663c8429cccc0b395f1fb48ea3f365f32b0a36
"""Golden granule DSP chain in numpy — the framework's correctness oracle.

This follows the reference decode flow (go-mp3 internal/frame/
frame.go:121-688) operation by operation, with the reference's dtype
discipline: float64 for the requantization power products, float32 working
spectra, float64 accumulation for the IMDCT/polyphase dot products (the
reference accumulates in float32 sequentially; float64 accumulation followed
by a float32 cast agrees to within 1 ulp of float32, which is far inside the
ISO full-compliance bound of maxdiff <= 2 LSB on int16 output).

It is intentionally a *separate implementation* from the vectorized JAX path
(go_mp3_tpu.ops.granule, and the port's ops.granule): the three are
cross-checked in tests, so an error in one's index maps or masks shows up
as a mismatch.

State per stream: `store` [2][32][18] overlap-add carry and `v_fifo`
[2][16][64] — the polyphase vVec (frame.go:48-49) kept as the FIFO of the
last 16 matrixed v vectors, which is the same information laid out for
batched consumption.
"""

from __future__ import annotations

import numpy as np

from .consts import SAMPLES_PER_GR, SF_BAND_INDICES
from .frameheader import FrameHeader
from .maindata import MainData
from .sideinfo import SideInfo
from . import tables as T


class GoldenDecoder:
    """Stateful per-stream golden decoder (one instance per audio stream)."""

    def __init__(self) -> None:
        self.store = np.zeros((2, 32, 18), dtype=np.float32)
        self.v_fifo = np.zeros((2, 16, 64), dtype=np.float32)

    # -- full frame ---------------------------------------------------------
    def decode_frame(
        self, header: FrameHeader, si: SideInfo, md: MainData
    ) -> bytes:
        nch = header.number_of_channels
        out = np.zeros((header.granules * SAMPLES_PER_GR, 2), dtype=np.int16)
        for gr in range(header.granules):
            xs = [None, None]
            for ch in range(nch):
                x = _requantize(header, si, md, gr, ch)
                x = _reorder(header, si, x, gr, ch)
                xs[ch] = x
            _stereo(header, si, md, xs, gr, nch)
            pcm_gr = np.zeros((SAMPLES_PER_GR, 2), dtype=np.int16)
            for ch in range(nch):
                x = _antialias(si, xs[ch], gr, ch)
                x = self._hybrid_synthesis(si, x, gr, ch)
                x *= T.FREQ_INV_SIGN.reshape(-1)
                pcm = self._subband_synthesis(x, ch)
                if nch == 1:
                    pcm_gr[:, 0] = pcm
                    pcm_gr[:, 1] = pcm
                else:
                    pcm_gr[:, ch] = pcm
            out[gr * SAMPLES_PER_GR : (gr + 1) * SAMPLES_PER_GR] = pcm_gr
        return out.tobytes()

    # -- hybrid (IMDCT + overlap-add) --------------------------------------
    def _hybrid_synthesis(
        self, si: SideInfo, x: np.ndarray, gr: int, ch: int
    ) -> np.ndarray:
        """frame.go:454-478; x is [576] f32, returns [576] f32."""
        out = np.empty(SAMPLES_PER_GR, dtype=np.float32)
        bt_gr = si.block_type[gr][ch]
        mixed = (
            si.win_switch_flag[gr][ch] == 1 and si.mixed_block_flag[gr][ch] == 1
        )
        for sb in range(32):
            bt = 0 if (mixed and sb < 2) else bt_gr
            block = x[sb * 18 : (sb + 1) * 18]
            rawout = _imdct_win(block, bt)
            out[sb * 18 : (sb + 1) * 18] = rawout[:18] + self.store[ch][sb]
            self.store[ch][sb] = rawout[18:]
        return out

    # -- polyphase ----------------------------------------------------------
    def _subband_synthesis(self, x: np.ndarray, ch: int) -> np.ndarray:
        """frame.go:630-688; x is [576] f32, returns int16 [576]."""
        pcm = np.empty(SAMPLES_PER_GR, dtype=np.int16)
        blocks = x.reshape(32, 18)
        nwin = T.SYNTH_N_WIN.astype(np.float64)
        dtbl = T.SYNTH_DTBL
        for ss in range(18):
            s_vec = blocks[:, ss].astype(np.float64)
            v = (nwin @ s_vec).astype(np.float32)
            fifo = self.v_fifo[ch]
            fifo[1:] = fifo[:-1]
            fifo[0] = v
            # u vector: even FIFO entries give their first 32 values, odd
            # entries their last 32 (frame.go:650-653 expressed blockwise)
            u = np.empty(512, dtype=np.float32)
            for b in range(8):
                u[64 * b : 64 * b + 32] = fifo[2 * b][:32]
                u[64 * b + 32 : 64 * b + 64] = fifo[2 * b + 1][32:]
            u = u * dtbl
            sums = u.reshape(16, 32).astype(np.float64).sum(axis=0)
            sums = sums.astype(np.float32)
            samp = np.trunc(np.float64(32767) * sums).astype(np.int64)
            np.clip(samp, -32767, 32767, out=samp)
            pcm[ss * 32 : (ss + 1) * 32] = samp.astype(np.int16)
        return pcm


# ---------------------------------------------------------------------------
# Stage implementations (module-level, stateless)
# ---------------------------------------------------------------------------


def _requantize(
    header: FrameHeader, si: SideInfo, md: MainData, gr: int, ch: int
) -> np.ndarray:
    """frame.go:184-255 — returns the f32 requantized spectrum [576]."""
    sfreq = header.sampling_frequency
    lsf = header.low_sampling_frequency
    long_bands = SF_BAND_INDICES[lsf][sfreq][0]
    short_bands = SF_BAND_INDICES[lsf][sfreq][1]

    raw = md.is_[gr][ch].astype(np.int64)
    sign = np.sign(raw).astype(np.float64)
    mag = T.POW_4_3_F64[np.abs(raw)]
    tmp2 = sign * mag

    sf_mult = 1.0 if si.scalefac_scale[gr][ch] != 0 else 0.5
    gg = float(si.global_gain[gr][ch])
    pre = float(si.preflag[gr][ch])

    idx = np.zeros(SAMPLES_PER_GR, dtype=np.float64)
    short_block = (
        si.win_switch_flag[gr][ch] == 1 and si.block_type[gr][ch] == 2
    )
    if short_block:
        mixed = si.mixed_block_flag[gr][ch] != 0
        start = 0
        if mixed:
            # first 36 lines use long bands (frame.go:190-199)
            for sfb in range(22):
                lo, hi = long_bands[sfb], min(long_bands[sfb + 1], 36)
                if lo >= 36:
                    break
                idx[lo:hi] = -(
                    sf_mult * (md.scalefac_l[gr][ch][sfb] + pre * T.PRETAB[sfb])
                ) + 0.25 * (gg - 210.0)
            start = 36
        first_sfb = 3 if mixed else 0
        for sfb in range(first_sfb, 13):
            base = 3 * short_bands[sfb]
            win_len = short_bands[sfb + 1] - short_bands[sfb]
            for win in range(3):
                lo = base + win * win_len
                idx[lo : lo + win_len] = -(
                    sf_mult * md.scalefac_s[gr][ch][sfb][win]
                ) + 0.25 * (
                    gg - 210.0 - 8.0 * si.subblock_gain[gr][ch][win]
                )
        del start
    else:
        for sfb in range(22):
            lo, hi = long_bands[sfb], long_bands[sfb + 1]
            idx[lo:hi] = -(
                sf_mult * (md.scalefac_l[gr][ch][sfb] + pre * T.PRETAB[sfb])
            ) + 0.25 * (gg - 210.0)

    return (np.exp2(idx) * tmp2).astype(np.float32)


def _reorder(
    header: FrameHeader, si: SideInfo, x: np.ndarray, gr: int, ch: int
) -> np.ndarray:
    """frame.go:257-302 — short-block win-major -> interleaved layout."""
    if not (
        si.win_switch_flag[gr][ch] == 1 and si.block_type[gr][ch] == 2
    ):
        return x
    sfreq = header.sampling_frequency
    lsf = header.low_sampling_frequency
    short_bands = SF_BAND_INDICES[lsf][sfreq][1]
    mixed = si.mixed_block_flag[gr][ch] != 0
    out = x.copy()
    first_sfb = 3 if mixed else 0
    for sfb in range(first_sfb, 13):
        base = 3 * short_bands[sfb]
        win_len = short_bands[sfb + 1] - short_bands[sfb]
        band = x[base : base + 3 * win_len].reshape(3, win_len)  # [win][j]
        out[base : base + 3 * win_len] = band.T.reshape(-1)  # [j][win]
    return out


def _stereo(
    header: FrameHeader,
    si: SideInfo,
    md: MainData,
    xs: list,
    gr: int,
    nch: int,
) -> None:
    """frame.go:361-420 — in-place MS and intensity stereo processing."""
    if nch != 2:
        return
    left, right = xs[0], xs[1]

    if header.use_ms_stereo:
        # Applying to all 576 lines is equivalent to the reference's
        # max(count1) bound: lines beyond both count1s are zero.
        new_left = (left + right) * T.INV_SQRT2
        new_right = (left - right) * T.INV_SQRT2
        left[:] = new_left
        right[:] = new_right

    if header.use_intensity_stereo:
        sfreq = header.sampling_frequency
        lsf = header.low_sampling_frequency
        long_bands = SF_BAND_INDICES[lsf][sfreq][0]
        short_bands = SF_BAND_INDICES[lsf][sfreq][1]
        count1_r = si.count1[gr][1]

        def intensity_long(sfb: int) -> None:
            is_pos = md.scalefac_l[gr][0][sfb]
            if is_pos >= 7:
                return
            lo, hi = long_bands[sfb], long_bands[sfb + 1]
            left[lo:hi] *= T.IS_RATIO_L[is_pos]
            right[lo:hi] *= T.IS_RATIO_R[is_pos]

        def intensity_short(sfb: int) -> None:
            win_len = short_bands[sfb + 1] - short_bands[sfb]
            for win in range(3):
                is_pos = md.scalefac_s[gr][0][sfb][win]
                if is_pos >= 7:
                    continue
                lo = short_bands[sfb] * 3 + win_len * win
                hi = lo + win_len
                left[lo:hi] *= T.IS_RATIO_L[is_pos]
                right[lo:hi] *= T.IS_RATIO_R[is_pos]

        short_block = (
            si.win_switch_flag[gr][0] == 1 and si.block_type[gr][0] == 2
        )
        if short_block:
            if si.mixed_block_flag[gr][0] != 0:
                for sfb in range(8):
                    if long_bands[sfb] >= count1_r:
                        intensity_long(sfb)
                for sfb in range(3, 12):
                    if short_bands[sfb] * 3 >= count1_r:
                        intensity_short(sfb)
            else:
                for sfb in range(12):
                    if short_bands[sfb] * 3 >= count1_r:
                        intensity_short(sfb)
        else:
            for sfb in range(21):
                if long_bands[sfb] >= count1_r:
                    intensity_long(sfb)


def _antialias(si: SideInfo, x: np.ndarray, gr: int, ch: int) -> np.ndarray:
    """frame.go:427-452 — butterflies across subband boundaries."""
    short_pure = (
        si.win_switch_flag[gr][ch] == 1
        and si.block_type[gr][ch] == 2
        and si.mixed_block_flag[gr][ch] == 0
    )
    if short_pure:
        return x
    sblim = 2 if (
        si.win_switch_flag[gr][ch] == 1
        and si.block_type[gr][ch] == 2
        and si.mixed_block_flag[gr][ch] == 1
    ) else 32
    out = x.copy()
    for sb in range(1, sblim):
        li = 18 * sb - 1 - np.arange(8)
        ui = 18 * sb + np.arange(8)
        lower = x[li]
        upper = x[ui]
        out[li] = lower * T.CS - upper * T.CA
        out[ui] = upper * T.CS + lower * T.CA
    return out


def _imdct_win(block: np.ndarray, block_type: int) -> np.ndarray:
    """imdct.go:83-108 — IMDCT + windowing for one 18-sample subband block."""
    out = np.zeros(36, dtype=np.float32)
    if block_type == 2:
        win = T.IMDCT_WIN[2]
        for i in range(3):
            sub = block[i::3].astype(np.float64)  # in[i + 3m], m=0..5
            s = (sub @ T.COS_N12.astype(np.float64)).astype(np.float32)
            out[6 * i + 6 : 6 * i + 18] += s * win[:12]
        return out
    vals = (
        block.astype(np.float64) @ T.COS_N36.astype(np.float64)
    ).astype(np.float32)
    return vals * T.IMDCT_WIN[block_type]
