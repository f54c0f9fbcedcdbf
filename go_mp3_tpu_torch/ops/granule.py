"""The granule DSP chain in plain PyTorch: the port's reference version.

Counterpart of go_mp3_tpu/ops/granule.py. The CPU tests hold it against the
JAX chain stage by stage, and chip_smoke.py holds each CUDA kernel of
ops/kernels.py against it on the card:

  requantize -> stereo                         (kernel K1, requant_stereo.cu)
  antialias -> IMDCT -> overlap-add -> freq inv (kernel K2, hybrid.cu)
  polyphase matrixing + FIR -> int16, state    (kernel K3, synth.cu)

decode_chunk_ref, the three in turn, is the plain version of the chain
kernel K5 (chain.cu), which runs them in one launch. energy_ref is the plain
version of the bench's energy kernel (energy.cu).

K1 also reads the fused wire rows of the corpus path (plain version
requant_stereo_fused_ref), whose unpack alone is kernel K4
(unpack_fused.cu; plain versions unpack_fused_ref and
unpack_fused_mono_ref).

Every tensor carries a leading stream axis written out: [S, T, ...] for S
streams of T granules each (the JAX package vmaps a [T, ...] function).

The math is the JAX chain's; its TPU workarounds are not carried over. The
per-band values reach the lines by indexing the per-line band maps, where
the JAX chain multiplies by one-hot expansion matrices, and the state after
`valid` granules is sliced out, where the JAX chain contracts with one-hot
rows. Both JAX forms are exact, so the values are the same.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..consts import HEAD_LINES, SAMPLES_PER_GR, SIDE8_WIDTH, SIDE_WIDTH

from . import tables as T

_F32 = torch.float32
_TAIL_LINES = SAMPLES_PER_GR - HEAD_LINES  # per-channel int8 tail lines


class GranuleBatch(NamedTuple):
    """S streams x T parsed granules (go_mp3_tpu/ops/granule.py:77-93)."""

    spectra: torch.Tensor  # int16 [S, T, 2, 576], post-reorder layout
    scalefac_l: torch.Tensor  # int32 [S, T, 2, 22]
    scalefac_s: torch.Tensor  # int32 [S, T, 2, 13, 3]
    global_gain: torch.Tensor  # int32 [S, T, 2]
    scalefac_scale: torch.Tensor  # int32 [S, T, 2]
    preflag: torch.Tensor  # int32 [S, T, 2]
    subblock_gain: torch.Tensor  # int32 [S, T, 2, 3]
    block_type: torch.Tensor  # int32 [S, T, 2]
    block_class: torch.Tensor  # int32 [S, T, 2] (0 long / 1 short / 2 mixed)
    variant: torch.Tensor  # int32 [S, T] (lsf * 3 + sfreq)
    ms_flag: torch.Tensor  # bool [S, T]
    is_flag: torch.Tensor  # bool [S, T]
    count1_r: torch.Tensor  # int32 [S, T]
    mono: torch.Tensor  # bool [S, T]


# each field's dtype and its shape past [S, T], as K1 reads them
BATCH_FIELDS = {
    "spectra": (torch.int16, (2, SAMPLES_PER_GR)),
    "scalefac_l": (torch.int32, (2, 22)),
    "scalefac_s": (torch.int32, (2, 13, 3)),
    "global_gain": (torch.int32, (2,)),
    "scalefac_scale": (torch.int32, (2,)),
    "preflag": (torch.int32, (2,)),
    "subblock_gain": (torch.int32, (2, 3)),
    "block_type": (torch.int32, (2,)),
    "block_class": (torch.int32, (2,)),
    "variant": (torch.int32, ()),
    "ms_flag": (torch.bool, ()),
    "is_flag": (torch.bool, ()),
    "count1_r": (torch.int32, ()),
    "mono": (torch.bool, ()),
}


def granule_batch_from_numpy(fields, device) -> GranuleBatch:
    """The 14 fields of a GranuleBatch as numpy arrays, in GranuleBatch's
    order (e.g. a go_mp3_tpu GranuleBatch), of one stream ([T, ...]) or
    stacked ([S, T, ...]) -> the port's GranuleBatch [S, T, ...] on
    `device`, each field contiguous in its BATCH_FIELDS dtype."""
    arrays = [np.asarray(a) for a in fields]
    if len(arrays) != len(BATCH_FIELDS):
        raise ValueError(f"{len(arrays)} fields, expected {len(BATCH_FIELDS)}")
    single = arrays[0].ndim == 3  # spectra [T, 2, 576]
    lead = (1, *arrays[0].shape[:1]) if single else arrays[0].shape[:2]
    out = []
    for a, (name, (dtype, inner)) in zip(arrays, BATCH_FIELDS.items()):
        if single:
            a = a[None]
        if a.shape != (*lead, *inner):
            raise ValueError(f"{name}: shape {a.shape}, expected {(*lead, *inner)}")
        t = torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(device=device, dtype=dtype))
    return GranuleBatch(*out)


def batch_to(b: GranuleBatch, device) -> GranuleBatch:
    """Every field of `b` on `device`."""
    return GranuleBatch(*(f.to(device) for f in b))


class DecodeState(NamedTuple):
    """Cross-chunk DSP state of S streams."""

    store: torch.Tensor  # f32 [S, 2, 32, 18] IMDCT overlap
    v_fifo: torch.Tensor  # f32 [S, 2, 16, 64] polyphase v rows, 0 = newest


def init_state(n_streams: int, device) -> DecodeState:
    return DecodeState(
        store=torch.zeros((n_streams, 2, 32, 18), dtype=_F32, device=device),
        v_fifo=torch.zeros((n_streams, 2, 16, 64), dtype=_F32, device=device),
    )


def state_from_numpy(store: np.ndarray, v_fifo: np.ndarray, device) -> DecodeState:
    """Numpy state ([S,2,32,18], [S,2,16,64] f32, e.g. a stacked JAX
    DecodeState) -> a DecodeState on `device`."""
    store = np.asarray(store, np.float32)
    v_fifo = np.asarray(v_fifo, np.float32)
    if store.shape[1:] != (2, 32, 18) or v_fifo.shape != (
        store.shape[0], 2, 16, 64
    ):
        raise ValueError(f"bad state shapes {store.shape}, {v_fifo.shape}")
    return DecodeState(
        store=torch.from_numpy(store.copy()).to(device),
        v_fifo=torch.from_numpy(v_fifo.copy()).to(device),
    )


def state_to_numpy(state: DecodeState) -> tuple[np.ndarray, np.ndarray]:
    return (
        state.store.detach().cpu().numpy(),
        state.v_fifo.detach().cpu().numpy(),
    )


class _Tables(NamedTuple):
    pow43: torch.Tensor
    pow2q: torch.Tensor
    pretab: torch.Tensor
    long_sfb: torch.Tensor  # [6, 576] long band of each line
    req_short: torch.Tensor  # [6, 576] sfb*3+win, requantize (composed) maps
    is_short: torch.Tensor  # [6, 576] sfb*3+win, intensity (win-major) maps
    long_start: torch.Tensor  # [6, 22] f32
    short_start: torch.Tensor  # [6, 39] f32, each band start repeated x3
    is_l: torch.Tensor
    is_r: torch.Tensor
    cs: torch.Tensor
    ca: torch.Tensor
    cos36: torch.Tensor
    short_m3: torch.Tensor
    imdct_win: torch.Tensor
    freq_inv: torch.Tensor
    n_win: torch.Tensor
    dtbl: torch.Tensor


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return _Tables(
        pow43=f32(T.POW_4_3_INT16),
        pow2q=f32(T.POW2_QUARTER),
        pretab=f32(T.PRETAB),
        long_sfb=i64(T.LONG_SFB_OF_LINE),
        req_short=i64(T.REQ_SHORT_SFB_OF_LINE * 3 + T.REQ_SHORT_WIN_OF_LINE),
        is_short=i64(T.SHORT_SFB_OF_LINE * 3 + T.SHORT_WIN_OF_LINE),
        long_start=f32(T.LONG_BAND_START[:, :22]),
        short_start=f32(np.repeat(T.SHORT_BAND_START3[:, :13], 3, axis=1)),
        is_l=f32(T.IS_RATIO_L),
        is_r=f32(T.IS_RATIO_R),
        cs=f32(T.CS),
        ca=f32(T.CA),
        cos36=f32(T.COS_N36),
        short_m3=f32(T.SHORT_M3),
        imdct_win=f32(T.IMDCT_WIN),
        freq_inv=f32(T.FREQ_INV_SIGN),
        n_win=f32(T.SYNTH_N_WIN),
        dtbl=f32(T.SYNTH_DTBL),
    )


def _to_lines(values: torch.Tensor, line_map: torch.Tensor) -> torch.Tensor:
    """Per-band values [S, T, 2, B] -> per-line [S, T, 2, 576] through the
    per-line band index line_map [S, T, 576]."""
    idx = line_map[:, :, None, :].expand(*values.shape[:3], SAMPLES_PER_GR)
    return torch.gather(values, 3, idx)


def _requantize(b: GranuleBatch) -> torch.Tensor:
    """sign(x) * |x|^(4/3) * 2^a with the per-band exponent a
    (go_mp3_tpu/ops/granule.py:242-279) -> f32 [S, T, 2, 576]. The JAX
    chain evaluates exp2(a + 4/3 log2|x|), as kernel K1 does; here both
    factors come from float64-rounded tables (the reference decoder's own
    formulation), which is as accurate and gives the same bits on every
    device and thread count."""
    tb = _tables(b.spectra.device)
    s_dim, t_dim = b.spectra.shape[:2]
    v = b.variant.long()

    sf_mult = torch.where(b.scalefac_scale != 0, 1.0, 0.5).to(_F32)
    gain = 0.25 * (b.global_gain.to(_F32) - 210.0)  # [S, T, 2]
    a_long_b = (
        -(sf_mult[..., None]
          * (b.scalefac_l.to(_F32)
             + b.preflag.to(_F32)[..., None] * tb.pretab))
        + gain[..., None]
    )  # [S, T, 2, 22]
    sbg39 = b.subblock_gain.to(_F32).repeat(1, 1, 1, 13)  # [.., sfb*3+win]
    a_short_b = (
        -(sf_mult[..., None]
          * b.scalefac_s.to(_F32).reshape(s_dim, t_dim, 2, 39))
        + gain[..., None]
        - 2.0 * sbg39
    )
    a_long = _to_lines(a_long_b, tb.long_sfb[v])
    a_short = _to_lines(a_short_b, tb.req_short[v])

    line = torch.arange(SAMPLES_PER_GR, device=v.device)
    cls = b.block_class[..., None]  # [S, T, 2, 1]
    is_long = (cls == T.CLASS_LONG) | ((cls == T.CLASS_MIXED) & (line < 36))
    a = torch.where(is_long, a_long, a_short)

    # a is a multiple of 1/4, so 2^a is a table entry, as |x|^(4/3) is
    q = (4.0 * a).round().long().clamp(T.POW2_QMIN, T.POW2_QMIN + len(T.POW2_QUARTER) - 1)
    mag = tb.pow43[b.spectra.long().abs()] * tb.pow2q[q - T.POW2_QMIN]
    return torch.sign(b.spectra).to(_F32) * mag


def _stereo(b: GranuleBatch, x: torch.Tensor) -> torch.Tensor:
    """MS stereo, then the long- and short-band intensity multipliers, both
    applied on a mixed block's overlap lines
    (go_mp3_tpu/ops/granule.py:290-358)."""
    tb = _tables(x.device)
    v = b.variant.long()
    left, right = x[:, :, 0], x[:, :, 1]

    ms = (b.ms_flag & ~b.mono)[..., None]
    new_l = (left + right) * float(T.INV_SQRT2)
    new_r = (left - right) * float(T.INV_SQRT2)
    left = torch.where(ms, new_l, left)
    right = torch.where(ms, new_r, right)

    c1r = b.count1_r.to(_F32)[..., None]  # [S, T, 1]
    gate = (b.is_flag & ~b.mono)[..., None]
    cls0 = b.block_class[..., 0][..., None]

    band_idx_l = torch.arange(22, device=x.device)
    is_pos_l = b.scalefac_l[:, :, 0]  # [S, T, 22]
    long_cap = torch.where(
        cls0 == T.CLASS_LONG, 20, torch.where(cls0 == T.CLASS_MIXED, 7, -1)
    )
    apply_l = (
        gate
        & (tb.long_start[v] >= c1r)
        & (band_idx_l <= long_cap)
        & (is_pos_l < 7)
    )

    sfb_idx = torch.arange(13, device=x.device).repeat_interleave(3)
    is_pos_s = b.scalefac_s[:, :, 0].reshape(*is_pos_l.shape[:2], 39)
    short_lo = torch.where(
        cls0 == T.CLASS_SHORT, 0, torch.where(cls0 == T.CLASS_MIXED, 3, 13)
    )
    apply_s = (
        gate
        & (tb.short_start[v] >= c1r)
        & (sfb_idx >= short_lo)
        & (sfb_idx <= 11)
        & (is_pos_s < 7)
    )

    def mults(apply, is_pos):
        k = is_pos.clamp(0, 6).long()
        one = torch.ones((), dtype=_F32, device=x.device)
        return torch.stack(
            [torch.where(apply, tb.is_l[k], one),
             torch.where(apply, tb.is_r[k], one)],
            dim=2,
        )  # [S, T, 2 (left/right multiplier), B]

    # multipliers travel as deltas from 1, as in the JAX chain, so the
    # composed (1 + dl) * (1 + ds) rounds the same way
    dl = _to_lines(mults(apply_l, is_pos_l) - 1.0, tb.long_sfb[v])
    ds = _to_lines(mults(apply_s, is_pos_s) - 1.0, tb.is_short[v])
    return torch.stack([left, right], dim=2) * ((1.0 + dl) * (1.0 + ds))


def _antialias(block_class: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """8 butterflies at each active subband boundary: all 31 for long
    blocks, boundary 0 only for mixed, none for short
    (go_mp3_tpu/ops/granule.py:361-381)."""
    tb = _tables(x.device)
    xb = x.reshape(*x.shape[:3], 32, 18)
    lower = xb[..., :31, 10:18].flip(-1)  # [.., 31, 8]: line 18b+17-i
    upper = xb[..., 1:, 0:8]
    lb = lower * tb.cs - upper * tb.ca
    ub = upper * tb.cs + lower * tb.ca

    cls = block_class[..., None]  # [S, T, 2, 1]
    bidx = torch.arange(31, device=x.device)
    active = torch.where(
        cls == T.CLASS_SHORT,
        False,
        torch.where(cls == T.CLASS_MIXED, bidx < 1, True),
    )[..., None]
    xb = xb.clone()
    xb[..., :31, 10:18] = torch.where(active, lb, lower).flip(-1)
    xb[..., 1:, 0:8] = torch.where(active, ub, upper)
    return xb.reshape(x.shape)


def _imdct(
    block_type: torch.Tensor, block_class: torch.Tensor, x: torch.Tensor
) -> torch.Tensor:
    """IMDCT-36 x window for block types 0/1/3, the composed short matrix
    for type 2, long windows on a mixed block's subbands 0-1
    (go_mp3_tpu/ops/granule.py:384-413) -> raw f32 [S, T, 2, 32, 36]."""
    tb = _tables(x.device)
    blocks = x.reshape(*x.shape[:3], 32, 18)
    sb_idx = torch.arange(32, device=x.device)
    mixed = (block_class == T.CLASS_MIXED)[..., None]
    bt_eff = torch.where(mixed & (sb_idx < 2), 0, block_type[..., None])
    raw_long = (blocks @ tb.cos36) * tb.imdct_win[bt_eff.long()]
    raw_short = blocks @ tb.short_m3
    return torch.where((bt_eff == 2)[..., None], raw_short, raw_long)


def _overlap_fold(
    raw: torch.Tensor, store_in: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """out = raw[t, :18] + raw[t-1, 18:], seeded by store_in; returns
    (out [S,T,2,32,18], uppers = raw[..., 18:])."""
    uppers = torch.cat([store_in[:, None], raw[:, :-1, ..., 18:]], dim=1)
    return raw[..., :18] + uppers, raw[..., 18:]


def _polyphase(
    x18: torch.Tensor, v_fifo_in: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Matrixing v = x18 . SYNTH_N_WIN per row, then the 16-tap FIR over the
    v history, taps k = 0..15 summed in order (go_mp3_tpu/ops/granule.py:
    423-490). Returns (pcm f32 [S, 2, T*18, 32], vh [S, 2, 16 + T*18, 64]
    with the 16 history rows oldest first)."""
    tb = _tables(x18.device)
    s_dim, t_dim = x18.shape[:2]
    rows = t_dim * 18
    v = x18.transpose(-1, -2) @ tb.n_win.T  # [S, T, 2, 18, 64]
    vf = v.transpose(1, 2).reshape(s_dim, 2, rows, 64)
    vh = torch.cat([v_fifo_in.flip(2), vf], dim=2)
    v_a = vh[..., :32]
    v_b = vh[..., 32:]
    acc = torch.zeros((s_dim, 2, rows, 32), dtype=_F32, device=x18.device)
    for k in range(16):
        src = v_a if k % 2 == 0 else v_b
        acc = acc + src[:, :, 16 - k : 16 - k + rows] * tb.dtbl[32 * k : 32 * (k + 1)]
    return acc, vh


# -- ginfo: the per-granule block geometry K1 hands to K2 and K3 ---------------
# int32 [S, T]: bits 0-1 block_type ch0, 2-3 block_type ch1, 4-5 block_class
# ch0, 6-7 block_class ch1, 8 mono.


def pack_ginfo(b: GranuleBatch) -> torch.Tensor:
    bt = b.block_type & 3
    cls = b.block_class & 3
    return (
        bt[..., 0] | (bt[..., 1] << 2) | (cls[..., 0] << 4)
        | (cls[..., 1] << 6) | (b.mono.to(torch.int32) << 8)
    ).to(torch.int32)


def ginfo_fields(ginfo: torch.Tensor):
    """-> (block_type [S,T,2], block_class [S,T,2], mono [S,T] bool)."""
    g = ginfo.to(torch.int32)
    bt = torch.stack([g & 3, (g >> 2) & 3], dim=-1)
    cls = torch.stack([(g >> 4) & 3, (g >> 6) & 3], dim=-1)
    return bt, cls, ((g >> 8) & 1).bool()


# -- the three kernels' plain versions -----------------------------------------


def requant_stereo_ref(b: GranuleBatch, stereo: bool = True):
    """K1's plain version -> (x f32 [S, T, 2, 576], ginfo int32 [S, T]).
    stereo=False stops after requantize (for checking K1 in two parts)."""
    x = _requantize(b)
    if stereo:
        x = _stereo(b, x)
    return x, pack_ginfo(b)


def hybrid_ref(x, ginfo, store, valid):
    """K2's plain version: antialias, IMDCT, overlap-add, frequency
    inversion -> (x18 f32 [S, T, 2, 32, 18], store after `valid` granules,
    unchanged where valid == 0; a copy of it when T == 0)."""
    if x.shape[1] == 0:
        return x.new_empty((x.shape[0], 0, 2, 32, 18)), store.clone()
    bt, cls, _ = ginfo_fields(ginfo)
    raw = _imdct(bt, cls, _antialias(cls, x))
    out18, uppers = _overlap_fold(raw, store)
    x18 = out18 * _tables(x.device).freq_inv
    s_idx = torch.arange(x.shape[0], device=x.device)
    last = uppers[s_idx, (valid.long() - 1).clamp(min=0)]
    store_out = torch.where(
        (valid > 0)[:, None, None, None], last, store
    )
    return x18, store_out


def synth_ref(x18, ginfo, v_fifo, valid):
    """K3's plain version: polyphase synthesis, x32767, clip, truncation
    to int16, the [T*576, 2] interleave with mono granules' ch0 copied to
    ch1, and the v FIFO after `valid` granules (vh rows valid*18 ..
    valid*18+15, newest first) -> (pcm int16 [S, T*576, 2], v_fifo)."""
    s_dim, t_dim = x18.shape[:2]
    pcm_f, vh = _polyphase(x18, v_fifo)
    samp = torch.clamp(pcm_f * 32767.0, -32767.0, 32767.0).to(torch.int32)
    pcm = samp.to(torch.int16).reshape(s_dim, 2, t_dim * SAMPLES_PER_GR)
    pcm = pcm.transpose(1, 2)  # [S, T*576, 2]
    _, _, mono = ginfo_fields(ginfo)
    mono_rows = mono[:, :, None].expand(s_dim, t_dim, SAMPLES_PER_GR)
    pcm = torch.where(
        mono_rows.reshape(s_dim, -1)[..., None], pcm[..., :1], pcm
    ).contiguous()
    rows = valid.long()[:, None] * 18 + torch.arange(16, device=x18.device)
    idx = rows[:, None, :, None].expand(s_dim, 2, 16, 64)
    fifo = torch.gather(vh, 2, idx).flip(2)
    return pcm, fifo


def decode_chunk_ref(
    b: GranuleBatch, state: DecodeState, valid: torch.Tensor
) -> tuple[torch.Tensor, DecodeState]:
    """S x T granules -> int16 PCM [S, T*576, 2] and the state after each
    stream's `valid` granules (go_mp3_tpu/ops/granule.py:493-549). Rows
    past valid*576 are padding output and are discarded by the caller."""
    x, ginfo = requant_stereo_ref(b)
    x18, store = hybrid_ref(x, ginfo, state.store, valid)
    pcm, fifo = synth_ref(x18, ginfo, state.v_fifo, valid)
    return pcm, DecodeState(store=store, v_fifo=fifo)


def energy_ref(pcm: torch.Tensor) -> torch.Tensor:
    """Per stream, the int32 sum of |int32(pcm)| over pcm int16 [S, N, 2],
    wrapping mod 2^32 as XLA's int32 sum does (bench.py:416-418): the
    plain version of the energy kernel (csrc/energy.cu). Taken in int64, so
    |-32768| is 32768 and the sum is exact before it wraps."""
    total = pcm.to(torch.int64).abs().sum(dim=(1, 2))
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


# -- packed host interfaces (layouts written by native/mp3parse.cpp) -----------


def _batch_from_side_words(spectra2: torch.Tensor, s: torch.Tensor) -> GranuleBatch:
    """spectra2 int16 [S, T, 1152] + side words int32 [S, T, 144]."""
    s_dim, t_dim = spectra2.shape[:2]
    flags = s[..., 1]
    return GranuleBatch(
        spectra=spectra2.reshape(s_dim, t_dim, 2, SAMPLES_PER_GR),
        scalefac_l=s[..., 22:66].reshape(s_dim, t_dim, 2, 22),
        scalefac_s=s[..., 66:144].reshape(s_dim, t_dim, 2, 13, 3),
        global_gain=s[..., 4:6],
        scalefac_scale=s[..., 6:8],
        preflag=s[..., 8:10],
        subblock_gain=s[..., 14:20].reshape(s_dim, t_dim, 2, 3),
        block_type=s[..., 10:12],
        block_class=s[..., 12:14],
        variant=s[..., 0],
        ms_flag=(flags & 1).bool(),
        is_flag=((flags >> 1) & 1).bool(),
        count1_r=s[..., 2],
        mono=((flags >> 2) & 1).bool(),
    )


def batch_from_packed(spectra2: torch.Tensor, side: torch.Tensor) -> GranuleBatch:
    """int16 spectra [S, T, 1152] + int16 side [S, T, 144]."""
    if side.shape[-1] != SIDE_WIDTH:
        raise ValueError(f"side width {side.shape[-1]} != {SIDE_WIDTH}")
    return _batch_from_side_words(spectra2, side.to(torch.int32))


def batch_from_packed8(
    tail8: torch.Tensor, head16: torch.Tensor, side8: torch.Tensor
) -> GranuleBatch:
    """int8 tail [S, T, 1024] (per-channel lines 64..575), int16 head
    [S, T, 128] (lines 0..63), u8 side [S, T, 168] (22 little-endian int16
    meta words, then the scalefactors as bytes)."""
    s_dim, t_dim = tail8.shape[:2]
    head = head16.reshape(s_dim, t_dim, 2, HEAD_LINES)
    tail = tail8.reshape(s_dim, t_dim, 2, SAMPLES_PER_GR - HEAD_LINES)
    spec = torch.cat([head, tail.to(torch.int16)], dim=-1)
    u = side8.to(torch.int32)
    meta = u[..., 0:44:2] | (u[..., 1:44:2] << 8)
    words = torch.cat([meta, u[..., 44:166]], dim=-1)
    return _batch_from_side_words(spec.reshape(s_dim, t_dim, 1152), words)


def _unpack_fused_rows(buf: torch.Tensor, t: int, tail_lines: int, nch: int):
    """K4's plain version over stereo (nch=2) or mono (nch=1) fused rows
    [S, n] u8 (ops/wire.py layout) -> (tail8 i8 [S,T,1024], head16 i16
    [S,T,128], side8 u8 [S,T,168]): tail lines past tail_lines are zero,
    and so is channel 1 of a mono row."""
    s_dim = buf.shape[0]
    head_lines = nch * HEAD_LINES
    a = nch * tail_lines * t
    b = a + t * 2 * head_lines
    tail = torch.zeros((s_dim, 2, _TAIL_LINES, t), dtype=torch.int8,
                       device=buf.device)
    tail[:, :nch, :tail_lines] = buf[:, :a].reshape(
        s_dim, nch, tail_lines, t).view(torch.int8)
    tail = tail.permute(0, 3, 1, 2).reshape(s_dim, t, 2 * _TAIL_LINES).contiguous()
    hb = buf[:, a:b].reshape(s_dim, t, head_lines, 2).to(torch.int32)
    v = hb[..., 0] | (hb[..., 1] << 8)
    head = torch.zeros((s_dim, t, 2 * HEAD_LINES), dtype=torch.int16,
                       device=buf.device)
    head[..., :head_lines] = (v - 2 * (v & 32768)).to(torch.int16)  # sign-extend
    side = buf[:, b:].reshape(s_dim, t, SIDE8_WIDTH).contiguous()
    return tail, head, side


def unpack_fused_ref(buf: torch.Tensor, t: int, tail_lines: int):
    """Stereo fused rows -> the packed8 arrays
    (go_mp3_tpu/ops/granule.py:661-683)."""
    return _unpack_fused_rows(buf, t, tail_lines, nch=2)


def unpack_fused_mono_ref(buf: torch.Tensor, t: int, tail_lines: int):
    """Mono fused rows -> the packed8 arrays, channel 1 zero
    (go_mp3_tpu/ops/granule.py:696-723)."""
    return _unpack_fused_rows(buf, t, tail_lines, nch=1)


def batch_from_fused(buf: torch.Tensor, t: int, tail_lines: int,
                     mono: bool = False) -> GranuleBatch:
    """Fused wire rows -> the GranuleBatch they carry (the unpack, then
    batch_from_packed8)."""
    unpack = unpack_fused_mono_ref if mono else unpack_fused_ref
    return batch_from_packed8(*unpack(buf, t, tail_lines))


def requant_stereo_fused_ref(buf: torch.Tensor, t: int, tail_lines: int,
                             mono: bool = False, stereo: bool = True):
    """K1's plain version on the fused wire rows: the unpack, then
    requant_stereo_ref."""
    return requant_stereo_ref(batch_from_fused(buf, t, tail_lines, mono), stereo)


def batch_from_any(packed) -> GranuleBatch:
    """(spectra2, side) -> batch_from_packed; (tail8, head16, side8) ->
    batch_from_packed8; a GranuleBatch as it is."""
    if isinstance(packed, GranuleBatch):
        return packed
    if len(packed) == 2:
        return batch_from_packed(*packed)
    return batch_from_packed8(*packed)
