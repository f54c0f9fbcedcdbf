"""The golden DSP of reference_dsp.py, run over all granules of a stream at once.

Each stage is the golden's (frame.go's) operation on the same dtypes:
float64 requantization power products and dot products, float32 spectra,
the same float32 additions in the same order. The dot products run as
batched matrix products, so their float64 sums may round in another order
than the golden's one-vector products; benchmark/tests holds the two
within 1 LSB, nearly all samples identical.

precision="tf32" is the control of the benchmark's output check: every
stage in float32, and the two matrix stages (the IMDCT and the polyphase
matrixing) on TF32 operands (10 mantissa bits, as a tensor core reads
float32) with float32 sums: what the chain would compute on tensor cores.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import tables as T
from .consts import SF_BAND_INDICES

PRECISIONS = ("float64", "tf32")


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10 mantissa bits (nearest, ties
    away from zero, as cvt.rna.tf32.f32)."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@dataclass
class Granules:
    """N granules of one stream, channels [N, 2] (a mono stream fills
    channel 0 and has nch 1): the fields the DSP reads."""

    lsf: int
    sfreq: int
    nch: int
    is_: np.ndarray  # [N, 2, 576] int32
    scalefac_l: np.ndarray  # [N, 2, 22]
    scalefac_s: np.ndarray  # [N, 2, 13, 3]
    global_gain: np.ndarray  # [N, 2]
    scalefac_scale: np.ndarray
    preflag: np.ndarray
    win_switch: np.ndarray
    block_type: np.ndarray
    mixed: np.ndarray
    subblock_gain: np.ndarray  # [N, 2, 3]
    ms: np.ndarray  # [N]


def granules_of(frames) -> Granules:
    """Granules of parsed frames (parser.ParsedFrame); intensity stereo is
    refused (the benchmark's streams never use it)."""
    h0 = frames[0].header
    rows = []
    for f in frames:
        h, si, md = f.header, f.side_info, f.main_data
        if h.use_intensity_stereo:
            raise NotImplementedError("intensity stereo")
        for gr in range(h.granules):
            rows.append((md.is_[gr], md.scalefac_l[gr], md.scalefac_s[gr],
                         si.global_gain[gr], si.scalefac_scale[gr], si.preflag[gr],
                         si.win_switch_flag[gr], si.block_type[gr],
                         si.mixed_block_flag[gr], si.subblock_gain[gr],
                         h.use_ms_stereo))
    cols = list(zip(*rows)) if rows else [()] * 11
    arr = [np.array(c) for c in cols]
    return Granules(h0.low_sampling_frequency, h0.sampling_frequency,
                    h0.number_of_channels, *arr)


def _long_band_of_line(lsf, sfreq):
    bands = np.array(SF_BAND_INDICES[lsf][sfreq][0])
    return np.searchsorted(bands, np.arange(576), side="right") - 1


def _short_maps(lsf, sfreq):
    """Per line of a short block (bitstream order): its sfb, its window,
    and the line it lands on after the reorder."""
    sb = SF_BAND_INDICES[lsf][sfreq][1]
    sfb = np.zeros(576, np.int64)
    win = np.zeros(576, np.int64)
    dest = np.arange(576)
    for b in range(13):
        base, w = 3 * sb[b], sb[b + 1] - sb[b]
        for k in range(3):
            lines = base + k * w + np.arange(w)
            sfb[lines], win[lines] = b, k
            dest[lines] = base + np.arange(w) * 3 + k
    return sfb, win, dest


def requantize(g: Granules) -> np.ndarray:
    """frame.go:184-255 -> float32 [N, 2, 576]."""
    raw = g.is_.astype(np.int64)
    tmp2 = np.sign(raw).astype(np.float64) * T.POW_4_3_F64[np.abs(raw)]
    sf_mult = np.where(g.scalefac_scale != 0, 1.0, 0.5)[..., None]
    gg = g.global_gain.astype(np.float64)[..., None]
    pre = g.preflag.astype(np.float64)[..., None]
    band = _long_band_of_line(g.lsf, g.sfreq)
    sfl = np.take_along_axis(g.scalefac_l, np.broadcast_to(band, raw.shape), -1)
    idx_long = -(sf_mult * (sfl + pre * T.PRETAB[band])) + 0.25 * (gg - 210.0)
    sfb, win, _ = _short_maps(g.lsf, g.sfreq)
    sfs = g.scalefac_s[..., sfb, win]  # [N, 2, 576]
    sbg = g.subblock_gain[..., win]
    idx_short = -(sf_mult * sfs) + 0.25 * (gg - 210.0 - 8.0 * sbg)
    short = ((g.win_switch == 1) & (g.block_type == 2))[..., None]
    mixed = (g.mixed != 0)[..., None]
    lines = np.arange(576)
    use_short = short & ~(mixed & (lines < 36))
    idx = np.where(use_short, idx_short, idx_long)
    return (np.exp2(idx) * tmp2).astype(np.float32)


def reorder(g: Granules, x: np.ndarray) -> np.ndarray:
    """frame.go:257-302: short blocks window-major -> interleaved."""
    _, _, dest = _short_maps(g.lsf, g.sfreq)
    short = (g.win_switch == 1) & (g.block_type == 2)
    out = x.copy()
    moved = np.empty_like(x)
    moved[..., dest] = x
    keep36 = (g.mixed != 0)[..., None] & (np.arange(576) < 36)
    sel = short[..., None] & ~keep36
    out[sel] = moved[sel]
    return out


def stereo(g: Granules, x: np.ndarray) -> None:
    """frame.go:361-420, MS only, in place."""
    if g.nch != 2:
        return
    ms = g.ms.astype(bool)
    left, right = x[ms, 0], x[ms, 1]
    x[ms, 0] = (left + right) * T.INV_SQRT2
    x[ms, 1] = (left - right) * T.INV_SQRT2


def antialias(g: Granules, x: np.ndarray) -> np.ndarray:
    """frame.go:427-452."""
    short = (g.win_switch == 1) & (g.block_type == 2)
    sblim = np.where(short & (g.mixed == 1), 2, 32)
    sblim = np.where(short & (g.mixed == 0), 1, sblim)
    out = x.copy()
    for sb in range(1, 32):
        li = 18 * sb - 1 - np.arange(8)
        ui = 18 * sb + np.arange(8)
        on = (sb < sblim)[..., None]
        lower, upper = x[..., li], x[..., ui]
        out[..., li] = np.where(on, lower * T.CS - upper * T.CA, lower)
        out[..., ui] = np.where(on, upper * T.CS + lower * T.CA, upper)
    return out


def _matmul(a, b, precision):
    """float32 [.., k] x [k, m] in the stage's precision -> float32."""
    if precision == "tf32":
        return np.matmul(tf32(a), tf32(b), dtype=np.float32)
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def imdct(g: Granules, x: np.ndarray, store: np.ndarray, precision: str) -> np.ndarray:
    """imdct.go:83-108 and the overlap-add of frame.go:454-478, granule
    after granule per channel; store [2, 32, 18] is carried in place."""
    n = x.shape[0]
    blocks = x.reshape(n, 2, 32, 18)
    bt = np.broadcast_to(g.block_type[..., None], (n, 2, 32)).copy()
    mixed_low = (g.win_switch == 1)[..., None] & (g.mixed == 1)[..., None] \
        & (np.arange(32) < 2)
    bt[mixed_low] = 0
    long_raw = _matmul(blocks, T.COS_N36, precision) * T.IMDCT_WIN[bt]
    short_raw = np.zeros_like(long_raw)
    win = T.IMDCT_WIN[2]
    for i in range(3):
        s = _matmul(blocks[..., i::3], T.COS_N12, precision)
        short_raw[..., 6 * i + 6: 6 * i + 18] += s * win[:12]
    raw = np.where((bt == 2)[..., None], short_raw, long_raw)  # [N, 2, 32, 36]
    prev = np.concatenate([store[None], raw[:-1, ..., 18:]], 0)
    out = raw[..., :18] + prev
    store[...] = raw[-1, ..., 18:]
    return out.reshape(n, 2, 576) * T.FREQ_INV_SIGN.reshape(-1)


def polyphase(x: np.ndarray, v_fifo: np.ndarray, precision: str) -> np.ndarray:
    """frame.go:630-688 over every time slot of one channel: x [N, 576]
    float32, v_fifo [16, 64] carried in place -> int16 [N * 576]."""
    n = x.shape[0]
    s = x.reshape(n, 32, 18).transpose(0, 2, 1).reshape(n * 18, 32)
    v = _matmul(s, T.SYNTH_N_WIN.T, precision)  # [slots, 64]
    hist = np.concatenate([v_fifo[::-1], v], 0)  # hist[16 + t] = slot t
    t = np.arange(n * 18)[:, None]
    b = np.arange(8)
    even = hist[16 + t - 2 * b][..., :32]  # fifo[2b][:32]
    odd = hist[16 + t - 2 * b - 1][..., 32:]  # fifo[2b + 1][32:]
    u = np.concatenate([even, odd], -1).reshape(n * 18, 512) * T.SYNTH_DTBL
    u = u.reshape(n * 18, 16, 32)
    if precision == "tf32":
        sums = u.sum(axis=1, dtype=np.float32)
    else:
        sums = u.astype(np.float64).sum(axis=1).astype(np.float32)
    samp = np.trunc(np.float64(32767) * sums).astype(np.int64)
    np.clip(samp, -32767, 32767, out=samp)
    v_fifo[...] = hist[-16:][::-1]
    return samp.astype(np.int16).reshape(-1)


class StreamDSP:
    """The DSP state of one stream (store, v_fifo) and its decode of granule
    batches -> s16le stereo PCM (mono duplicated)."""

    def __init__(self, precision: str = "float64"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.store = np.zeros((2, 32, 18), np.float32)
        self.v_fifo = np.zeros((2, 16, 64), np.float32)

    def decode(self, g: Granules) -> np.ndarray:
        n = len(g.is_)
        if n == 0:
            return np.zeros((0, 2), np.int16)
        x = reorder(g, requantize(g))
        stereo(g, x)
        x = antialias(g, x)
        x = imdct(g, x, self.store, self.precision)
        out = np.empty((n * 576, 2), np.int16)
        for ch in range(g.nch):
            out[:, ch] = polyphase(x[:, ch], self.v_fifo[ch], self.precision)
        if g.nch == 1:
            out[:, 1] = out[:, 0]
        return out
