"""A seeded writer of the low-rate rungs of an encoder's CBR ladder: MPEG-1
Layer III joint stereo at 32 kHz, and MPEG-2 LSF Layer III joint stereo at
24 kHz, and a catalogue that mixes them with mp3gen's 44.1 kHz clips.

What mp3gen writes at 44.1 kHz, at another rate: a spectrum of quantized
lines falling with frequency up to the rung's lowpass, scalefactors, block
types, MS stereo on most frames (intensity stereo never), and the side info
and Huffman code an encoder writes for them; each frame fills its bit
budget through the reservoir, each big-values region takes its cheapest
Huffman table. Per format:

 - MPEG-1 at 32 kHz: two granules a frame of 144 * bitrate / 32000 bytes
   (432 at 96 kbps, never padded), 32 bytes of stereo side info, scfsi,
   a 9-bit main_data_begin (511 bytes back), the 32 kHz band tables;
 - MPEG-2 LSF at 24 kHz: one granule a frame of 72 * bitrate / 24000 bytes
   (192 at 64 kbps, never padded), 17 bytes of stereo side info, LSF
   scalefactors for each channel (mp3gen_lsf's partitions; preflag implied
   at scalefac_compress >= 500), an 8-bit main_data_begin (255 bytes
   back), the 24 kHz band tables, no mixed blocks.

The Huffman code tables, the quantizer, the big-values layout, the table
choice, count1, the bit writer, the block kinds, MPEG-1's part 2 and side
info are mp3gen's; the LSF scalefactors are mp3gen_lsf's. What reads a
module's sample rate or bands there (frame sizes, padding, the lowpass
line, the line frequencies, the region bounds, the loudness) takes the
format's here. Tail lines stay within int8 from per-channel line 64 after
the short-block reorder (from the start of the short band that holds line
64, times three, in short and mixed blocks).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import roofline
from . import mp3gen, mp3gen_lsf, traffic
from .mp3gen import LONG, MIXED, PAIR_CODE, PAIR_LEN, PAIR_TABLES, QUAD_CODE, QUAD_LEN, SHORT, START, STOP

SAMPLES_PER_GRANULE = 576
BYTES_PER_GRANULE_PCM = SAMPLES_PER_GRANULE * 4  # s16le stereo
HEADER_BYTES = 4
MAX_PART23 = 4095


@dataclass(frozen=True)
class Format:
    """A Layer III stereo format: its MPEG version (lsf 0: MPEG-1, 1: MPEG-2
    LSF), sampling rate, the header's sampling-frequency index and its
    scalefactor band tables (ISO/IEC 11172-3 Table B.8, 13818-3 Table B.2)."""

    lsf: int
    sample_rate: int
    sfreq: int
    long_bands: tuple
    short_bands: tuple

    @property
    def granules(self) -> int:
        return 1 if self.lsf else 2

    @property
    def samples_per_frame(self) -> int:
        return SAMPLES_PER_GRANULE * self.granules

    @property
    def side_info_bytes(self) -> int:
        return 17 if self.lsf else 32  # stereo

    @property
    def max_mdb(self) -> int:
        return 255 if self.lsf else 511

    def bitrate_index(self, kbps: int) -> int:
        return (mp3gen_lsf if self.lsf else mp3gen).BITRATE_INDEX[kbps]

    def _frame_num(self, kbps: int) -> int:
        return (72 if self.lsf else 144) * kbps * 1000

    def frame_bytes(self, kbps: int, padding: int) -> int:
        return self._frame_num(kbps) // self.sample_rate + padding

    def paddings(self, kbps: int, n: int) -> np.ndarray:
        """An encoder's padding: a frame is padded whenever the rest of
        frame_num / rate left over from the frames before reaches a byte."""
        num = self._frame_num(kbps)
        rest = (np.arange(1, n + 1) * num) % self.sample_rate
        prev = (np.arange(0, n) * num) % self.sample_rate
        return (rest < prev).astype(np.int64)

    def lowpass_line(self, hz: float) -> int:
        return int(round(hz / (self.sample_rate / 2) * 576))

    def tail_from_short(self) -> int:
        """The per-channel line of a short block's bitstream order from
        which its lines stay within int8: the short band holding line 64
        is reordered within itself."""
        sb = np.array(self.short_bands)
        return 3 * int(sb[3 * sb <= 64].max())


MPEG1_44K = Format(0, 44100, 0, tuple(mp3gen.LONG_BANDS), tuple(mp3gen.SHORT_BANDS))
MPEG1_32K = Format(0, 32000, 2,
                   (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
                    194, 240, 296, 364, 448, 550, 576),
                   (0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192))
MPEG2_24K = Format(1, 24000, 1,
                   (0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194,
                    232, 278, 332, 394, 464, 540, 576),
                   (0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192))
FORMATS = {("MPEG-1", 44100): MPEG1_44K, ("MPEG-1", 32000): MPEG1_32K,
           ("MPEG-2", 24000): MPEG2_24K}


def format_of(rung: dict) -> Format:
    """The Format of a configuration's rung {"version", "sample_rate"}."""
    return FORMATS[(rung["version"], int(rung["sample_rate"]))]


# -- spectra and the Huffman layout ----------------------------------------------


def _line_freq(kind: np.ndarray, fmt: Format) -> np.ndarray:
    """Long-block frequency index of each bitstream line, per granule [G, 576]:
    short blocks hold lines band by band, window by window; mixed blocks
    hold lines 0-35 as a long block."""
    sb = fmt.short_bands
    f_short = np.empty(576, np.int64)
    for sfb in range(13):
        lo, hi = sb[sfb], sb[sfb + 1]
        f_short[3 * lo:3 * hi] = 3 * (lo + np.tile(np.arange(hi - lo), 3))
    f_mixed = f_short.copy()
    f_mixed[:36] = np.arange(36)
    out = np.where((kind == SHORT)[:, None], f_short, np.arange(576))
    return np.where((kind == MIXED)[:, None], f_mixed, out)


def region_bounds(kind, big_values, r0, r1, fmt: Format):
    """Line bounds [G, 4] of the three big-values regions as a decoder
    reads them: short and mixed blocks split at line 36; start and stop
    blocks at the long band 8 (region0_count 7); long blocks at the bands
    the region counts name."""
    lb = np.array(fmt.long_bands)
    end = 2 * big_values
    j = r0 + r1 + 2
    ws_short = np.isin(kind, (SHORT, MIXED))
    b1 = np.where(ws_short, 36, np.where(kind == LONG, lb[np.minimum(r0 + 1, 22)], lb[8]))
    b2 = np.where(kind == LONG, np.where(j >= 23, 576, lb[np.minimum(j, 22)]), 576)
    b1 = np.minimum(b1, end)
    b2 = np.minimum(np.maximum(b2, b1), end)
    return np.stack([np.zeros_like(b1), b1, b2, end], 1)


def part3_bits(qa, kind, fmt: Format):
    """Huffman bits of each granule's magnitudes qa [G, 576], and the side
    info fields they imply (mp3gen.part3_bits with the format's regions)."""
    bv, n1 = mp3gen._layout(qa)
    nb = np.searchsorted(np.array(fmt.long_bands), 2 * bv, side="left")
    r0 = np.clip(np.rint(nb * 0.3).astype(np.int64) - 1, 0, 15)
    r1 = np.clip(np.rint(nb * 0.65).astype(np.int64) - r0 - 2, 0, 7)
    tables, bits = mp3gen._choose_tables(qa, region_bounds(kind, bv, r0, r1, fmt))
    c1, nc = mp3gen._count1(qa, bv, n1)
    fields = {"big_values": bv, "count1_quads": n1, "region0_count": r0,
              "region1_count": r1, "table_select": tables, "count1table_select": c1}
    return bits + nc, fields


def _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg, fmt: Format):
    """RMS over a granule of the requantized lines at global gain 210."""
    lb, sb = np.array(fmt.long_bands), np.array(fmt.short_bands)
    mag = np.abs(q).astype(np.float64) ** (4.0 / 3.0)
    mult = np.where(sfscale == 1, 1.0, 0.5)[:, None]
    band = np.searchsorted(lb, np.arange(576), side="right") - 1
    exp_long = mult * (sf_l[:, band] + preflag[:, None] * mp3gen.PRETAB[band])
    short_band = np.searchsorted(sb * 3, np.arange(576), side="right") - 1
    lo = sb[short_band]
    win = (np.arange(576) - 3 * lo) // (sb[short_band + 1] - lo)
    exp_short = mult * sf_s[:, short_band, win] + 2.0 * np.take_along_axis(
        sbg, np.broadcast_to(win, q.shape), 1)
    exp = np.where((kind == SHORT)[:, None], exp_short, exp_long)
    mixed = np.where(np.arange(576) < 36, exp_long, exp_short)
    exp = np.where((kind == MIXED)[:, None], mixed, exp)
    return np.sqrt(np.mean((mag * 2.0 ** -exp) ** 2, axis=1))


# -- a run of frames ----------------------------------------------------------------


def _mpeg1_scalefactors(rng, kind, n_frames):
    """mp3gen's MPEG-1 scalefactors: scalefac_compress, slen, scfsi (granule
    1 repeats granule 0's bands where neither is short or mixed), the bands
    copied and part 2's bits."""
    G = len(kind)
    sfc = rng.choice([0, 5, 6, 7, 8, 9, 10, 11, 12, 13], G)
    slen = mp3gen.SLEN[sfc]
    scfsi = np.zeros((n_frames, 2, 4), np.int64)
    for f in range(n_frames):
        for ch in range(2):
            if kind[4 * f + ch] not in (SHORT, MIXED) and kind[4 * f + 2 + ch] not in (SHORT, MIXED):
                scfsi[f, ch] = rng.random(4) < 0.3
    copy = np.zeros((G, 4), np.int64)
    copy[2::4] = scfsi[:, 0]
    copy[3::4] = scfsi[:, 1]
    return sfc, slen, scfsi, copy, mp3gen.part2_bits(kind, slen, copy)


def _mpeg1_scalefactor_values(rng, kind, slen, scfsi):
    """mp3gen's scalefactor values, preflag and the scfsi copies."""
    G = len(kind)
    sf_l = (rng.random((G, 22)) * (1 << slen[:, :1].repeat(22, 1))).astype(np.int64)
    sf_l[:, 11:] = (rng.random((G, 11)) * (1 << slen[:, 1:].repeat(11, 1))).astype(np.int64)
    sf_l[:, 21] = 0
    sf_s = np.zeros((G, 13, 3), np.int64)
    sf_s[:, :6] = (rng.random((G, 6, 3)) * (1 << slen[:, :1, None])).astype(np.int64)
    sf_s[:, 6:12] = (rng.random((G, 6, 3)) * (1 << slen[:, 1:2, None])).astype(np.int64)
    for f in range(len(scfsi)):
        for ch in range(2):
            for band, (a, b) in enumerate(mp3gen.SCFSI_BANDS):
                if scfsi[f, ch, band]:
                    sf_l[4 * f + 2 + ch, a:b] = sf_l[4 * f + ch, a:b]
    preflag = ((rng.random(G) < 0.1) & (kind == LONG)).astype(np.int64)
    return sf_l, sf_s, preflag


def make_run_fields(rng: np.random.Generator, fmt: Format, bitrate_kbps: int, n_frames: int, *,
                    lowpass_hz: float, short_share: float, mixed_share: float,
                    ms_share: float, loudness_rms: float, run_frames: int | None = None):
    """n_frames joint stereo frames of `fmt` whose bit reservoir restarts
    (main_data_begin 0) every run_frames frames (never, by default) ->
    (bytes, frame starts [n_frames + 1], the fields written for each
    granule and channel in (frame, granule, channel) order, MS per frame).
    Keywords as mp3gen.make_run_fields'; mixed_share must be 0 at LSF."""
    if fmt.lsf and mixed_share:
        raise ValueError("the LSF writer writes no mixed blocks")
    run_frames = run_frames or n_frames
    fresh = np.arange(n_frames) % run_frames == 0
    ngr = fmt.granules
    per_frame = 2 * ngr  # granule-channels a frame
    G = per_frame * n_frames
    kinds_gr = np.concatenate([
        mp3gen._block_kinds(rng, ngr * min(run_frames, n_frames - f), short_share, mixed_share)
        for f in range(0, n_frames, run_frames)])
    kind = np.repeat(kinds_gr, 2)
    ms = rng.random(n_frames) < ms_share
    side = np.tile([False, True], G // 2) & np.repeat(ms, per_frame)
    short = np.isin(kind, (SHORT, MIXED))

    # spectral shape: a slope per run and granule, Laplacian lines, lowpass
    freq = _line_freq(kind, fmt)
    slope = rng.uniform(1.0, 1.5) + rng.normal(0, 0.08, G)
    shape = (1.0 + freq / 6.0) ** -slope[:, None]
    shape = shape * np.abs(rng.laplace(0, 1, (G, 576)))
    shape[freq >= fmt.lowpass_line(lowpass_hz)] = 0

    if fmt.lsf:
        table, slen, sfc, preflag, p2 = mp3gen_lsf._scalefactors(rng, kind, np.zeros(G, bool))
    else:
        sfc, slen, scfsi, copy, p2 = _mpeg1_scalefactors(rng, kind, n_frames)

    # targets: the reservoir, simulated on the targets themselves
    pad = np.concatenate([fmt.paddings(bitrate_kbps, min(run_frames, n_frames - f))
                          for f in range(0, n_frames, run_frames)])
    slot = np.array([fmt.frame_bytes(bitrate_kbps, p) - HEADER_BYTES - fmt.side_info_bytes
                     for p in pad])
    pos = np.concatenate([[0], np.cumsum(slot)])
    want = slot * 8 * rng.uniform(0.8, 1.2, n_frames)
    weight = (np.where(short, 1.6, 1.0) * np.where(side, 0.55, 1.0)).reshape(n_frames, per_frame)
    target = np.zeros(G, np.int64)
    end = 0  # bits, in the main-data stream
    for f in range(n_frames):
        start = pos[f] if fresh[f] else max(-(-end // 8), pos[f] - fmt.max_mdb)
        avail = (pos[f] + slot[f] - start) * 8
        t_f = min(want[f], avail)
        share = np.floor(t_f * weight[f] / weight[f].sum()).astype(np.int64)
        target[per_frame * f:per_frame * (f + 1)] = np.minimum(share, MAX_PART23)
        end = start * 8 + target[per_frame * f:per_frame * (f + 1)].sum()

    # the quantizer scale: the largest whose bits fit the target
    tail_from = np.where(short, fmt.tail_from_short(), 64)
    budget = target - p2
    lo = np.full(G, 1.0 / 64)
    hi = np.full(G, 4096.0)
    for _ in range(13):
        mid = np.sqrt(lo * hi)
        bits, _f = part3_bits(mp3gen._quantize(mid, shape, tail_from), kind, fmt)
        ok = bits <= budget
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)
    qa = mp3gen._quantize(lo, shape, tail_from)
    bits, fields = part3_bits(qa, kind, fmt)
    assert (bits <= budget).all()
    q = qa * np.where(rng.random((G, 576)) < 0.5, -1, 1)

    # scalefactor values, gains and loudness
    if fmt.lsf:
        sf_l, sf_s, flat = mp3gen_lsf._scalefactor_values(rng, kind, table, slen)
    else:
        sf_l, sf_s, preflag = _mpeg1_scalefactor_values(rng, kind, slen, scfsi)
    sfscale = (rng.random(G) < 0.1).astype(np.int64)
    sbg = np.where(short[:, None], rng.choice([0, 0, 0, 1, 2], (G, 3)), 0)
    rms_210 = _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg, fmt)
    # loudness varies by frame (3 dB), the MS side channel 10 dB down
    level = loudness_rms * np.where(side, 0.3, 1.0) * np.repeat(
        10 ** (rng.normal(0, 3, n_frames) / 20), per_frame)
    gg = np.clip(np.rint(210 + 4 * np.log2(level / np.maximum(rms_210, 1e-30))), 0, 255)
    gg = np.where(qa.any(1), gg, 0).astype(np.int64)

    gcs = [dict(kind=int(kind[i]), q=q[i], sfc=int(sfc[i]), slen=slen[i],
                sf_l=sf_l[i], sf_s=sf_s[i], preflag=int(preflag[i]),
                sfscale=int(sfscale[i]), sbg=sbg[i], gg=int(gg[i]),
                big_values=int(fields["big_values"][i]), n1=int(fields["count1_quads"][i]),
                r0=int(fields["region0_count"][i]), r1=int(fields["region1_count"][i]),
                tables=fields["table_select"][i], c1=int(fields["count1table_select"][i]),
                part23=int(p2[i] + bits[i]))
           for i in range(G)]
    for i, gc in enumerate(gcs):
        if fmt.lsf:
            gc.update(table=int(table[i]), sf_flat=flat[i])
        else:
            gc.update(copy=copy[i])
    data, starts = _assemble(fmt, bitrate_kbps, pad, slot, pos, ms,
                             None if fmt.lsf else scfsi, gcs, fresh)
    return data, starts, gcs, ms


# -- the bitstream --------------------------------------------------------------------


def _part3(b: mp3gen._Bits, gc, fmt: Format) -> None:
    """The granule's big values, region by region, then its count1 quads."""
    q, bv = gc["q"], gc["big_values"]
    bounds = region_bounds(np.array([gc["kind"]]), np.array([bv]), np.array([gc["r0"]]),
                           np.array([gc["r1"]]), fmt)[0]
    for t, a, e in zip(gc["tables"], bounds[:3], bounds[1:]):
        if t == 0 or e <= a:
            continue
        book, lb, _ = PAIR_TABLES[int(t)]
        x, y = q[a:e:2], q[a + 1:e:2]
        ax, ay = np.abs(x), np.abs(y)
        xc, yc = np.minimum(ax, 15), np.minimum(ay, 15)
        vals = np.zeros((len(x), 5), np.int64)
        nb = np.zeros((len(x), 5), np.int64)
        vals[:, 0], nb[:, 0] = PAIR_CODE[book, xc, yc], PAIR_LEN[book, xc, yc]
        if lb:
            vals[:, 1], nb[:, 1] = ax - 15, np.where(ax >= 15, lb, 0)
            vals[:, 3], nb[:, 3] = ay - 15, np.where(ay >= 15, lb, 0)
        vals[:, 2], nb[:, 2] = x < 0, ax > 0
        vals[:, 4], nb[:, 4] = y < 0, ay > 0
        b.put(np.maximum(vals, 0), nb)
    n1 = gc["n1"]
    if n1:
        quads = q[2 * bv: 2 * bv + 4 * n1].reshape(n1, 4)
        aq = np.abs(quads)
        v = (aq[:, 0] << 3) | (aq[:, 1] << 2) | (aq[:, 2] << 1) | aq[:, 3]
        vals = np.zeros((n1, 5), np.int64)
        nb = np.zeros((n1, 5), np.int64)
        vals[:, 0], nb[:, 0] = QUAD_CODE[gc["c1"], v], QUAD_LEN[gc["c1"], v]
        vals[:, 1:], nb[:, 1:] = quads < 0, aq > 0
        b.put(vals, nb)


def _side_info_lsf(mdb: int, two) -> bytes:
    """17 bytes of MPEG-2 LSF stereo side info: an 8-bit main_data_begin,
    two private bits, then each channel's one granule (a 9-bit
    scalefac_compress, no scfsi, no preflag bit)."""
    b = mp3gen._Bits()
    b.put([mdb, 0], [8, 2])
    for gc in two:
        b.put([gc["part23"], gc["big_values"], gc["gg"], gc["sfc"]], [12, 9, 8, 9])
        k = gc["kind"]
        if k == LONG:
            b.put(0, 1)
            b.put(list(gc["tables"]) + [gc["r0"], gc["r1"]], [5, 5, 5, 4, 3])
        else:
            bt = {START: 1, SHORT: 2, STOP: 3}[k]
            b.put([1, bt, 0], [1, 2, 1])
            b.put(list(gc["tables"][:2]) + list(gc["sbg"]), [5, 5, 3, 3, 3])
        b.put([gc["sfscale"], gc["c1"]], 1)
    bits = b.bits()
    assert len(bits) == 8 * 17
    return np.packbits(bits).tobytes()


def _assemble(fmt: Format, bitrate_kbps, pad, slot, pos, ms, scfsi, gcs, fresh):
    n_frames = len(slot)
    per_frame = 2 * fmt.granules
    stream = np.zeros(8 * int(pos[-1]), np.uint8)  # the main-data space, in bits
    frames = []
    end = 0
    for f in range(n_frames):
        start = int(pos[f]) if fresh[f] else max(-(-end // 8), int(pos[f]) - fmt.max_mdb)
        mdb = int(pos[f]) - start
        assert 0 <= mdb <= fmt.max_mdb
        b = mp3gen._Bits()
        own = gcs[per_frame * f:per_frame * (f + 1)]
        for gc in own:
            n0 = b.total()
            if fmt.lsf:
                b.put(*gc["sf_flat"])
            else:
                mp3gen._part2(b, gc)
            _part3(b, gc, fmt)
            assert b.total() - n0 == gc["part23"], (b.total() - n0, gc["part23"])
        bits = b.bits()
        stream[8 * start: 8 * start + len(bits)] = bits
        end = 8 * start + len(bits)
        assert end <= 8 * int(pos[f] + slot[f])
        header = (0xFFF << 20) | ((1 - fmt.lsf) << 19) | (1 << 17) | (1 << 16) \
            | (fmt.bitrate_index(bitrate_kbps) << 12) | (fmt.sfreq << 10) | (int(pad[f]) << 9) \
            | (1 << 6) | ((2 if ms[f] else 0) << 4) | (1 << 2)  # joint stereo, no CRC
        si = _side_info_lsf(mdb, own) if fmt.lsf else mp3gen._side_info(mdb, scfsi[f], own)
        frames.append((header.to_bytes(4, "big"), si))
    data = np.packbits(stream).tobytes()
    out, starts = [], [0]
    for f, (h, si) in enumerate(frames):
        out += [h, si, data[int(pos[f]):int(pos[f] + slot[f])]]
        starts.append(starts[-1] + HEADER_BYTES + fmt.side_info_bytes + int(slot[f]))
    return b"".join(out), np.array(starts)


# -- streams for a cell -----------------------------------------------------------


@dataclass
class Stream(traffic.Stream):
    """A stream of one rung: frames of samples_per_frame samples at
    sample_rate, decoded to s16le stereo."""

    sample_rate: int = 44100
    samples_per_frame: int = 1152

    @property
    def seconds(self) -> float:
        return self.frames * self.samples_per_frame / self.sample_rate

    @property
    def pcm_bytes(self) -> int:
        return self.frames * self.frame_pcm_bytes

    @property
    def frame_pcm_bytes(self) -> int:
        return self.samples_per_frame * 4

    @property
    def granules(self) -> int:
        return self.frames * self.samples_per_frame // SAMPLES_PER_GRANULE


def frame_work(gcs, fmt: Format, ms) -> tuple[np.ndarray, np.ndarray]:
    """The chain's work on each frame (benchmark/roofline.py), counted from
    the fields written: both channels' operations, the main data read and
    the stereo PCM written."""
    n_gr = len(gcs) // 2
    q = np.stack([g["q"] for g in gcs]).reshape(n_gr, 2, 576)
    kind = np.array([g["kind"] for g in gcs]).reshape(n_gr, 2)
    ops = roofline.granule_ops(q, np.isin(kind, (SHORT, MIXED)), kind == MIXED,
                               np.repeat(ms, fmt.granules))
    bits = np.array([g["part23"] for g in gcs]).reshape(n_gr, 2)
    nbytes = roofline.granule_bytes(bits)
    n_frames = len(ms)
    return (ops.reshape(n_frames, -1).sum(1).astype(np.float64),
            nbytes.reshape(n_frames, -1).sum(1))


def make_pool(cfg: dict, rng: np.random.Generator, fmt: Format, bitrate_kbps: int) -> list:
    """cfg["pool"] runs of cfg["pool"] frames of one rung, each with its own
    reservoir -> [traffic.Run]."""
    n_runs = cfg["pool"]["runs_per_bitrate"]
    run_frames = cfg["pool"]["frames_per_run"]
    data, starts, gcs, ms = make_run_fields(
        rng, fmt, bitrate_kbps, n_runs * run_frames, run_frames=run_frames,
        lowpass_hz=cfg["lowpass_hz"][str(bitrate_kbps)], short_share=cfg["short_share"],
        mixed_share=0.0 if fmt.lsf else cfg["mixed_share"], ms_share=cfg["ms_share"],
        loudness_rms=cfg["loudness_rms"])
    ops, nbytes = frame_work(gcs, fmt, ms)
    runs = []
    for r in range(n_runs):
        a, b = r * run_frames, (r + 1) * run_frames
        s = starts[a:b + 1]
        runs.append(traffic.Run(data[s[0]:s[-1]], s - s[0], ops[a:b], nbytes[a:b]))
    return runs


def frames_for(seconds: float, fmt: Format) -> int:
    return int(np.ceil(seconds * fmt.sample_rate / fmt.samples_per_frame))


def clip_batches(cfg: dict, wl: dict, seed: int) -> list[list[Stream]]:
    """The catalogue's clips, in batches of the workload's batch_clips: each
    batch holds the mix's count of each rung (traffic.bitrate_counts), in
    an order drawn from the seed, each clip cfg["clip_seconds"] long at its
    rung's rate. A rung at 44.1 kHz MPEG-1 is mp3gen's (traffic.make_pool);
    the others are written here."""
    rng = traffic.rng_for(seed, 1)
    mix = cfg["bitrate_mix"]
    fmts = {int(k): format_of(cfg["rungs"][k]) for k in mix}
    pool = {}
    for br in sorted(fmts):
        if fmts[br] == MPEG1_44K:
            pool[br] = traffic.make_pool(cfg, rng, [br])[br]
        else:
            pool[br] = make_pool(cfg, rng, fmts[br], br)
    n = wl["batch_clips"]
    batches = []
    for _ in range(cfg["catalogue_clips"] // n):
        rates = [br for br, c in traffic.bitrate_counts(mix, n).items() for _ in range(c)]
        rng.shuffle(rates)
        batch = []
        for br in rates:
            fmt = fmts[br]
            s = traffic.compose(rng, pool[br], br, frames_for(cfg["clip_seconds"], fmt))
            batch.append(Stream(**vars(s), sample_rate=fmt.sample_rate,
                                samples_per_frame=fmt.samples_per_frame))
        batches.append(batch)
    return batches
