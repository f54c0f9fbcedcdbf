"""A seeded writer of valid MPEG-1 Layer III streams, 44.1 kHz joint stereo.

It makes what an encoder's bitstream holds, without an encoder's analysis:
per granule and channel a spectrum of quantized lines whose magnitudes fall
with frequency and stop at the bitrate's lowpass, scalefactors, block types
(long, start, short, stop, mixed), and the side info and Huffman code that
an encoder writes for them:

 - each frame's main data fills the frame's bit budget at the stream's
   bitrate: a granule's quantizer scale is searched (all granules at once)
   until its Huffman-coded lines and scalefactors take the bits it was given;
 - each big-values region takes the Huffman table that codes it in the
   fewest bits, as an encoder picks it, and count1 takes table A or B;
 - the bit reservoir carries bits between the frames of a run: a frame's
   target varies around the budget, and its main data starts up to 511
   bytes back (main_data_begin) in the previous frames' main-data space;
 - MS stereo is on in most frames; intensity stereo is never used.

A run of frames starts with main_data_begin 0, so runs concatenate into
valid streams in any order (compose). Tail lines stay within int8, as on
real streams: per-channel lines 64 and up after the short-block reorder,
so from line 48 in short and mixed blocks (their scalefactor band 4,
lines 48-65, is reordered within itself).
"""

from __future__ import annotations

import numpy as np

from .huffman_tables import TABLES

SAMPLE_RATE = 44100
SAMPLES_PER_FRAME = 1152
SIDE_INFO_BYTES = 32  # MPEG-1 stereo
HEADER_BYTES = 4
MAX_MDB = 511  # 9-bit main_data_begin
MAX_PART23 = 4095  # 12-bit part2_3_length

BITRATE_INDEX = {32: 1, 40: 2, 48: 3, 56: 4, 64: 5, 80: 6, 96: 7, 112: 8,
                 128: 9, 160: 10, 192: 11, 224: 12, 256: 13, 320: 14}

# ISO/IEC 11172-3 Table B.8, 44.1 kHz
LONG_BANDS = np.array((0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110,
                       134, 162, 196, 238, 288, 342, 418, 576))
SHORT_BANDS = np.array((0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192))
# (slen1, slen2) per scalefac_compress, Table B.6
SLEN = np.array(((0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
                 (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3)))
PRETAB = np.array((0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 3, 2, 0))
SCFSI_BANDS = ((0, 6), (6, 11), (11, 16), (16, 21))

LONG, START, SHORT, STOP, MIXED = 0, 1, 2, 3, 4  # block kinds

# -- Huffman code tables, built from the codebooks ---------------------------

_INF = 1 << 20


def _pair_books():
    """Per table number 1..31: (book id, linbits, max literal value); per
    book: code and length [16, 16] (length _INF where the book has no
    entry)."""
    books: dict[int, int] = {}
    codes, lens, tables = [], [], {}
    for t, (book, linbits) in enumerate(TABLES[:32]):
        if book is None:
            continue
        if id(book) not in books:
            books[id(book)] = len(codes)
            c = np.zeros((16, 16), np.int64)
            n = np.full((16, 16), _INF, np.int64)
            for length, code, x, y in book:
                c[x, y], n[x, y] = code, length
            codes.append(c)
            lens.append(n)
        vmax = max(max(x, y) for _, _, x, y in book)
        tables[t] = (books[id(book)], linbits, vmax)
    return np.stack(codes), np.stack(lens), tables


PAIR_CODE, PAIR_LEN, PAIR_TABLES = _pair_books()
_TABLE_IDS = tuple(sorted(PAIR_TABLES))
QUAD_CODE = np.zeros((2, 16), np.int64)
QUAD_LEN = np.zeros((2, 16), np.int64)
for _i, (_book, _) in enumerate(TABLES[32:34]):
    for _length, _code, _, _v in _book:
        QUAD_CODE[_i, _v], QUAD_LEN[_i, _v] = _code, _length


def frame_bytes(bitrate_kbps: int, padding: int) -> int:
    return 144 * bitrate_kbps * 1000 // SAMPLE_RATE + padding


def paddings(bitrate_kbps: int, n: int) -> np.ndarray:
    """An encoder's padding bits: a frame is padded whenever the rest of
    144 * bitrate / rate left over from the frames before reaches a byte."""
    num = 144 * bitrate_kbps * 1000
    rest = (np.arange(1, n + 1) * num) % SAMPLE_RATE
    prev = (np.arange(0, n) * num) % SAMPLE_RATE
    return (rest < prev).astype(np.int64)


def lowpass_line(hz: float) -> int:
    return int(round(hz / (SAMPLE_RATE / 2) * 576))


# -- spectra --------------------------------------------------------------------


def _line_freq(kind: np.ndarray) -> np.ndarray:
    """Long-block frequency index of each bitstream line, per granule [G, 576]:
    short blocks hold lines sfb by sfb, window by window."""
    f_long = np.arange(576)
    f_short = np.empty(576, np.int64)
    for sfb in range(13):
        lo, hi = SHORT_BANDS[sfb], SHORT_BANDS[sfb + 1]
        w = hi - lo
        f_short[3 * lo:3 * hi] = 3 * (lo + np.tile(np.arange(w), 3))
    f_mixed = f_short.copy()
    f_mixed[:36] = f_long[:36]
    out = np.where((kind == SHORT)[:, None], f_short, f_long)
    return np.where((kind == MIXED)[:, None], f_mixed, out)


def _quantize(scale, shape, tail_from):
    """Quantized magnitudes [G, 576] at per-granule scales (int64); lines
    from tail_from [G] on stay within int8."""
    q = np.rint(scale[:, None] * shape)
    q = np.where(np.arange(576)[None] >= tail_from[:, None], np.minimum(q, 127), q)
    return np.minimum(q, 8206).astype(np.int64)


def _layout(qa):
    """big_values (pairs) and count1 quads of magnitudes qa [G, 576]."""
    rev_nz = (qa > 0)[:, ::-1]
    last_nz = np.where(rev_nz.any(1), 575 - rev_nz.argmax(1), -1)
    rev_big = (qa > 1)[:, ::-1]
    last_big = np.where(rev_big.any(1), 575 - rev_big.argmax(1), -1)
    bv = (last_big + 2) // 2  # pairs
    n1 = np.maximum(0, -(-(last_nz + 1 - 2 * bv) // 4))
    over = 2 * bv + 4 * n1 > 576
    bv = np.where(over, bv + 1, bv)
    n1 = np.where(over, np.maximum(0, -(-(last_nz + 1 - 2 * bv) // 4)), n1)
    return bv, n1


def _regions(kind, bv):
    """Region starts (lines) and region0/1 counts: window-switched granules
    split at line 36; long blocks near a third and two thirds of the big
    values, on scalefactor band edges."""
    end = 2 * bv
    nb = np.searchsorted(LONG_BANDS, end, side="left")  # bands to cover it
    r0 = np.clip(np.rint(nb * 0.3).astype(np.int64) - 1, 0, 15)
    r1 = np.clip(np.rint(nb * 0.65).astype(np.int64) - r0 - 2, 0, 7)
    b1 = LONG_BANDS[np.minimum(r0 + 1, 22)]
    j = r0 + r1 + 2
    b2 = np.where(j >= 23, 576, LONG_BANDS[np.minimum(j, 22)])
    ws = kind != LONG
    b1 = np.where(ws, 36, b1)
    b2 = np.where(ws, 576, b2)
    return np.minimum(b1, end), np.minimum(np.maximum(b2, b1), end), r0, r1


# per (x, y) code of a pair (both capped at 15): each book's length, the
# sign bits and the escaped values, as columns [256, books + 2]
_PAIR_COLS = np.concatenate([
    PAIR_LEN.reshape(len(PAIR_LEN), 256).T,
    ((np.arange(256) // 16 > 0).astype(np.int64) + (np.arange(256) % 16 > 0))[:, None],
    ((np.arange(256) // 16 == 15).astype(np.int64) + (np.arange(256) % 16 == 15))[:, None],
], 1).astype(np.float64)


def _choose_tables(qa, bounds):
    """Per region r (lines [bounds[r], bounds[r + 1]) of each granule), the
    table that codes it in the fewest bits -> (tables [G, 3], bits [G])."""
    g = qa.shape[0]
    x, y = qa[:, 0::2], qa[:, 1::2]
    code = np.minimum(x, 15) * 16 + np.minimum(y, 15)
    pair = np.arange(288)
    region = (pair[None] >= bounds[:, 1:2] // 2).astype(np.int64) \
        + (pair[None] >= bounds[:, 2:3] // 2)
    inside = pair[None] < bounds[:, 3:4] // 2
    key = (np.arange(g)[:, None] * 3 + region) * 256 + code
    hist = np.bincount(key[inside], minlength=3 * g * 256).reshape(3 * g, 256)
    sums = (hist.astype(np.float64) @ _PAIR_COLS).astype(np.int64).reshape(g, 3, -1)
    book_bits, sign_bits, n_esc = sums[..., :-2], sums[..., -2], sums[..., -1]
    pmax = np.where(inside, np.maximum(x, y), 0)
    m = np.stack([np.where(region == r, pmax, 0).max(1) for r in range(3)], 1)
    cost = np.full((len(_TABLE_IDS),) + m.shape, _INF, np.int64)
    for r, t in enumerate(_TABLE_IDS):
        book, lb, vmax = PAIR_TABLES[t]
        fits = m <= vmax if lb == 0 else m - 15 < (1 << lb)
        cost[r] = np.where(fits, book_bits[..., book] + lb * n_esc, _INF)
    best = cost.argmin(0)
    tables = np.where(m > 0, np.array(_TABLE_IDS)[best], 0)
    bits = np.where(m > 0, np.take_along_axis(cost, best[None], 0)[0] + sign_bits, 0)
    return tables, bits.sum(1)


def _count1(qa, bv, n1):
    """count1 quads from line 2*bv: -> (table 0/1 for A/B [G], bits [G])."""
    g = qa.shape[0]
    pos = 2 * bv[:, None] + np.arange(576)[None]
    vals = np.where(pos < 576, np.take_along_axis(qa, np.minimum(pos, 575), 1), 0)
    quads = vals[:, : 576].reshape(g, 144, 4)
    inside = np.arange(144)[None] < n1[:, None]
    v = (quads[..., 0] << 3) | (quads[..., 1] << 2) | (quads[..., 2] << 1) | quads[..., 3]
    signs = np.where(inside, quads.sum(-1), 0).sum(1)
    a = np.where(inside, QUAD_LEN[0][v], 0).sum(1)
    b = 4 * n1
    return (b < a).astype(np.int64), np.minimum(a, b) + signs


def part3_bits(qa, kind):
    """Huffman bits of each granule's magnitudes qa [G, 576], and the side
    info fields they imply (big_values, region counts, tables)."""
    bv, n1 = _layout(qa)
    b1, b2, r0, r1 = _regions(kind, bv)
    bounds = np.stack([np.zeros_like(b1), b1, b2, 2 * bv], 1)
    tables, nb = _choose_tables(qa, bounds)
    c1, nc = _count1(qa, bv, n1)
    fields = {"big_values": bv, "count1_quads": n1, "region0_count": r0,
              "region1_count": r1, "table_select": tables,
              "count1table_select": c1}
    return nb + nc, fields


def part2_bits(kind, slen, scfsi_copy):
    """Scalefactor bits per granule: slen [G, 2]; scfsi_copy [G, 4] bands
    copied from granule 0 (granule 1 of long blocks only)."""
    s1, s2 = slen[:, 0], slen[:, 1]
    widths = np.array([b - a for a, b in SCFSI_BANDS])
    per_band = np.stack([widths[0] * s1, widths[1] * s1, widths[2] * s2, widths[3] * s2], 1)
    long_bits = (per_band * (1 - scfsi_copy)).sum(1)
    short_bits = 18 * s1 + 18 * s2  # sfb 0-5 and 6-11, three windows
    mixed_bits = 17 * s1 + 18 * s2  # 8 long + sfb 3-5 x3, sfb 6-11 x3
    out = np.where(kind == SHORT, short_bits, long_bits)
    return np.where(kind == MIXED, mixed_bits, out)


# -- a run of frames --------------------------------------------------------------


def _block_kinds(rng, n_gr, short_share, mixed_share):
    """Block kinds over n_gr granules (both channels alike): long, with
    transients start -> 1-2 short (or mixed) -> stop."""
    kinds = np.full(n_gr, LONG)
    i = 1
    p = short_share / 1.5  # a transient holds 1.5 short granules on average
    while i < n_gr - 3:
        if rng.random() < p:
            n = 1 + int(rng.random() < 0.5)
            short = MIXED if rng.random() < mixed_share / short_share else SHORT
            kinds[i] = START
            kinds[i + 1:i + 1 + n] = short
            kinds[i + 1 + n] = STOP
            i += n + 3
        else:
            i += 1
    return kinds


def make_runs(rng: np.random.Generator, bitrate_kbps: int, n_runs: int,
              run_frames: int, **kw) -> list[tuple[bytes, np.ndarray]]:
    """n_runs runs of run_frames frames, each with its own bit reservoir ->
    [(bytes, frame start offsets [run_frames + 1])]. Keywords: lowpass_hz,
    short_share, mixed_share, ms_share, loudness_rms (make_run_fields)."""
    data, starts, _ = make_run_fields(rng, bitrate_kbps, n_runs * run_frames,
                                      run_frames=run_frames, **kw)
    out = []
    for r in range(n_runs):
        s = starts[r * run_frames:(r + 1) * run_frames + 1]
        out.append((data[s[0]:s[-1]], s - s[0]))
    return out


def make_run_fields(rng: np.random.Generator, bitrate_kbps: int, n_frames: int, *,
                    lowpass_hz: float, short_share: float, mixed_share: float,
                    ms_share: float, loudness_rms: float, run_frames: int | None = None):
    """n_frames frames whose bit reservoir restarts (main_data_begin 0) every
    run_frames frames (never, by default) -> (bytes, frame starts, the
    fields written for each granule and channel in (frame, granule,
    channel) order). lowpass_hz: the encoder's lowpass; short_share and
    mixed_share: the shares of granules in short and mixed blocks;
    ms_share: the share of frames in MS stereo; loudness_rms: the RMS of
    the requantized lines (full scale 1)."""
    run_frames = run_frames or n_frames
    fresh = np.arange(n_frames) % run_frames == 0
    n_gr = 2 * n_frames
    G = 2 * n_gr  # granule-channels, order (frame, gr, ch)
    kinds_gr = np.concatenate([
        _block_kinds(rng, 2 * min(run_frames, n_frames - f), short_share, mixed_share)
        for f in range(0, n_frames, run_frames)])
    kind = np.repeat(kinds_gr, 2)
    ms = rng.random(n_frames) < ms_share
    side = np.tile([0, 1], n_gr).astype(bool) & np.repeat(ms, 4)

    # spectral shape: a slope per run and granule, Laplacian lines, lowpass
    freq = _line_freq(kind)
    slope = rng.uniform(1.0, 1.5) + rng.normal(0, 0.08, G)
    shape = (1.0 + freq / 6.0) ** -slope[:, None]
    shape = shape * np.abs(rng.laplace(0, 1, (G, 576)))
    shape[freq >= lowpass_line(lowpass_hz)] = 0

    # scalefactors and their bits
    sfc = rng.choice([0, 5, 6, 7, 8, 9, 10, 11, 12, 13], G)
    slen = SLEN[sfc]
    scfsi = np.zeros((n_frames, 2, 4), np.int64)
    for f in range(n_frames):
        for ch in range(2):
            if kind[4 * f + ch] != SHORT and kind[4 * f + 2 + ch] not in (SHORT, MIXED) \
                    and kind[4 * f + ch] != MIXED:
                scfsi[f, ch] = rng.random(4) < 0.3
    copy = np.zeros((G, 4), np.int64)
    copy[2::4] = scfsi[:, 0]
    copy[3::4] = scfsi[:, 1]
    p2 = part2_bits(kind, slen, copy)

    # targets: the reservoir, simulated on the targets themselves
    pad = np.concatenate([paddings(bitrate_kbps, min(run_frames, n_frames - f))
                          for f in range(0, n_frames, run_frames)])
    slot = np.array([frame_bytes(bitrate_kbps, p) - HEADER_BYTES - SIDE_INFO_BYTES
                     for p in pad])
    pos = np.concatenate([[0], np.cumsum(slot)])
    want = slot * 8 * rng.uniform(0.8, 1.2, n_frames)
    weight = np.where(np.isin(kind, (SHORT, MIXED)), 1.6, 1.0) * np.where(side, 0.55, 1.0)
    weight = weight.reshape(n_frames, 4)
    target = np.zeros(G, np.int64)
    end = 0  # bits, in the main-data stream
    for f in range(n_frames):
        start = pos[f] if fresh[f] else max(-(-end // 8), pos[f] - MAX_MDB)
        avail = (pos[f] + slot[f] - start) * 8
        t_f = min(want[f], avail)
        share = np.floor(t_f * weight[f] / weight[f].sum()).astype(np.int64)
        target[4 * f:4 * f + 4] = np.minimum(share, MAX_PART23)
        end = start * 8 + target[4 * f:4 * f + 4].sum()

    # the quantizer scale: the largest whose bits fit the target
    tail_from = np.where(np.isin(kind, (SHORT, MIXED)), 48, 64)
    budget = target - p2
    lo = np.full(G, 0.25)
    hi = np.full(G, 4096.0)
    for _ in range(11):
        mid = np.sqrt(lo * hi)
        bits, _f = part3_bits(_quantize(mid, shape, tail_from), kind)
        ok = bits <= budget
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)
    qa = _quantize(lo, shape, tail_from)
    bits, fields = part3_bits(qa, kind)
    assert (bits <= budget).all()
    q = qa * np.where(rng.random((G, 576)) < 0.5, -1, 1)

    # scalefactor values, gains and loudness
    sf_l = (rng.random((G, 22)) * (1 << slen[:, :1].repeat(22, 1))).astype(np.int64)
    sf_l[:, 11:] = (rng.random((G, 11)) * (1 << slen[:, 1:].repeat(11, 1))).astype(np.int64)
    sf_l[:, 21] = 0
    sf_s = np.zeros((G, 13, 3), np.int64)
    sf_s[:, :6] = (rng.random((G, 6, 3)) * (1 << slen[:, :1, None])).astype(np.int64)
    sf_s[:, 6:12] = (rng.random((G, 6, 3)) * (1 << slen[:, 1:2, None])).astype(np.int64)
    for f in range(n_frames):  # scfsi: granule 1 repeats granule 0's bands
        for ch in range(2):
            for band, (a, b) in enumerate(SCFSI_BANDS):
                if scfsi[f, ch, band]:
                    sf_l[4 * f + 2 + ch, a:b] = sf_l[4 * f + ch, a:b]
    preflag = ((rng.random(G) < 0.1) & (kind == LONG)).astype(np.int64)
    sfscale = (rng.random(G) < 0.1).astype(np.int64)
    sbg = np.where(np.isin(kind, (SHORT, MIXED))[:, None],
                   rng.choice([0, 0, 0, 1, 2], (G, 3)), 0)
    rms_210 = _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg)
    # loudness varies by frame (3 dB), the MS side channel 10 dB down
    level = loudness_rms * np.where(side, 0.3, 1.0) * np.repeat(
        10 ** (rng.normal(0, 3, n_frames + 1) / 20), 4)[:G]
    gg = np.clip(np.rint(210 + 4 * np.log2(level / np.maximum(rms_210, 1e-30))), 0, 255)
    gg = np.where(qa.any(1), gg, 0).astype(np.int64)

    gcs = [dict(kind=int(kind[i]), q=q[i], sfc=int(sfc[i]), slen=slen[i],
                sf_l=sf_l[i], sf_s=sf_s[i], copy=copy[i], preflag=int(preflag[i]),
                sfscale=int(sfscale[i]), sbg=sbg[i], gg=int(gg[i]),
                big_values=int(fields["big_values"][i]),
                n1=int(fields["count1_quads"][i]),
                r0=int(fields["region0_count"][i]), r1=int(fields["region1_count"][i]),
                tables=fields["table_select"][i],
                c1=int(fields["count1table_select"][i]),
                part23=int(p2[i] + bits[i]))
           for i in range(G)]
    data, starts = _assemble(bitrate_kbps, pad, slot, pos, ms, scfsi, gcs, fresh)
    return data, starts, gcs


def _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg):
    """RMS over a granule of the requantized lines at global gain 210."""
    mag = np.abs(q).astype(np.float64) ** (4.0 / 3.0)
    mult = np.where(sfscale == 1, 1.0, 0.5)[:, None]
    band = np.searchsorted(LONG_BANDS, np.arange(576), side="right") - 1
    exp_long = mult * (sf_l[:, band] + preflag[:, None] * PRETAB[band])
    exp = exp_long
    short_band = np.searchsorted(SHORT_BANDS * 3, np.arange(576), side="right") - 1
    lo = SHORT_BANDS[short_band]
    width = SHORT_BANDS[short_band + 1] - lo
    win = (np.arange(576) - 3 * lo) // width
    sf_short = sf_s[:, short_band, win]
    exp_short = mult * sf_short + 2.0 * np.take_along_axis(sbg, np.broadcast_to(win, q.shape), 1)
    exp = np.where((kind == SHORT)[:, None], exp_short, exp)
    mixed = np.where(np.arange(576) < 36, exp_long, exp_short)
    exp = np.where((kind == MIXED)[:, None], mixed, exp)
    return np.sqrt(np.mean((mag * 2.0 ** -exp) ** 2, axis=1))


class _Bits:
    """MSB-first bit fields, packed in one go."""

    def __init__(self):
        self.vals: list = []
        self.nbits: list = []

    def put(self, vals, nbits) -> None:
        self.vals.append(np.asarray(vals, np.int64).ravel())
        self.nbits.append(np.broadcast_to(np.asarray(nbits, np.int64),
                                          np.shape(vals)).ravel())

    def total(self) -> int:
        return int(sum(n.sum() for n in self.nbits))

    def bits(self) -> np.ndarray:
        vals = np.concatenate(self.vals) if self.vals else np.zeros(0, np.int64)
        nb = np.concatenate(self.nbits) if self.nbits else np.zeros(0, np.int64)
        keep = nb > 0
        vals, nb = vals[keep], nb[keep]
        idx = np.repeat(np.arange(len(nb)), nb)
        starts = np.concatenate([[0], np.cumsum(nb)[:-1]])
        off = np.arange(int(nb.sum())) - starts[idx]
        return ((vals[idx] >> (nb[idx] - 1 - off)) & 1).astype(np.uint8)


def _part2(b: _Bits, gc) -> None:
    s1, s2 = int(gc["slen"][0]), int(gc["slen"][1])
    k = gc["kind"]
    if k == SHORT:
        b.put(gc["sf_s"][:6].ravel(), s1)
        b.put(gc["sf_s"][6:12].ravel(), s2)
    elif k == MIXED:
        b.put(gc["sf_l"][:8], s1)
        b.put(gc["sf_s"][3:6].ravel(), s1)
        b.put(gc["sf_s"][6:12].ravel(), s2)
    else:
        for band, (a, e) in enumerate(SCFSI_BANDS):
            if not gc["copy"][band]:
                b.put(gc["sf_l"][a:e], s1 if band < 2 else s2)


def _part3(b: _Bits, gc) -> None:
    q = gc["q"]
    bv = gc["big_values"]
    ws = gc["kind"] != LONG
    if ws:
        b1 = min(36, 2 * bv)
        b2 = 2 * bv
    else:
        b1 = min(int(LONG_BANDS[gc["r0"] + 1]), 2 * bv)
        j = gc["r0"] + gc["r1"] + 2
        b2 = min(max(576 if j >= 23 else int(LONG_BANDS[j]), b1), 2 * bv)
    for t, a, e in zip(gc["tables"], (0, b1, b2), (b1, b2, 2 * bv)):
        if t == 0 or e <= a:
            continue
        book, lb, _ = PAIR_TABLES[int(t)]
        x, y = q[a:e:2], q[a + 1:e:2]
        ax, ay = np.abs(x), np.abs(y)
        xc, yc = np.minimum(ax, 15), np.minimum(ay, 15)
        n = len(x)
        vals = np.zeros((n, 5), np.int64)
        nb = np.zeros((n, 5), np.int64)
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


def _side_info(mdb, scfsi, gcs) -> bytes:
    b = _Bits()
    b.put(mdb, 9)
    b.put(0, 3)  # private bits
    b.put(scfsi.ravel(), 1)
    for gc in gcs:  # (gr, ch)
        b.put([gc["part23"], gc["big_values"], gc["gg"], gc["sfc"]], [12, 9, 8, 4])
        k = gc["kind"]
        if k == LONG:
            b.put(0, 1)
            b.put(list(gc["tables"]) + [gc["r0"], gc["r1"]], [5, 5, 5, 4, 3])
        else:
            bt = {START: 1, SHORT: 2, STOP: 3, MIXED: 2}[k]
            b.put([1, bt, int(k == MIXED)], [1, 2, 1])
            b.put(list(gc["tables"][:2]) + list(gc["sbg"]), [5, 5, 3, 3, 3])
        b.put([gc["preflag"], gc["sfscale"], gc["c1"]], 1)
    bits = b.bits()
    assert len(bits) == 8 * SIDE_INFO_BYTES
    return np.packbits(bits).tobytes()


def _assemble(bitrate_kbps, pad, slot, pos, ms, scfsi, gcs, fresh):
    n_frames = len(slot)
    stream = np.zeros(8 * int(pos[-1]), np.uint8)  # the main-data space, in bits
    frames = []
    end = 0
    for f in range(n_frames):
        start = int(pos[f]) if fresh[f] else max(-(-end // 8), int(pos[f]) - MAX_MDB)
        mdb = int(pos[f]) - start
        assert 0 <= mdb <= MAX_MDB
        b = _Bits()
        four = gcs[4 * f:4 * f + 4]
        for gc in four:
            n0 = b.total()
            _part2(b, gc)
            _part3(b, gc)
            assert b.total() - n0 == gc["part23"], (b.total() - n0, gc["part23"])
        bits = b.bits()
        stream[8 * start: 8 * start + len(bits)] = bits
        end = 8 * start + len(bits)
        assert end <= 8 * int(pos[f] + slot[f])
        header = (0xFFF << 20) | (1 << 19) | (1 << 17) | (1 << 16) \
            | (BITRATE_INDEX[bitrate_kbps] << 12) | (int(pad[f]) << 9) \
            | (1 << 6) | ((2 if ms[f] else 0) << 4) | (1 << 2)
        frames.append((header.to_bytes(4, "big"), _side_info(mdb, scfsi[f], four)))
    data = np.packbits(stream).tobytes()
    out, starts = [], [0]
    for f, (h, si) in enumerate(frames):
        out += [h, si, data[int(pos[f]):int(pos[f] + slot[f])]]
        starts.append(starts[-1] + HEADER_BYTES + SIDE_INFO_BYTES + int(slot[f]))
    return b"".join(out), np.array(starts)
