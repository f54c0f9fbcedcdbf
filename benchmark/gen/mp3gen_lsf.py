"""A seeded writer of valid MPEG-2 LSF Layer III streams: 22.05 kHz mono speech.

What mp3gen writes for MPEG-1 stereo, at the low sampling frequency of
ISO/IEC 13818-3, with a spectrum, scalefactors, block types (long, start,
short, stop; no mixed blocks) and the side info and Huffman code an encoder
writes for them:

 - one granule a frame, of 72 * bitrate / 22050 bytes (156 or 157 at 48
   kbps, padded as an encoder pads);
 - 9 bytes of mono side info: an 8-bit main_data_begin, a 9-bit
   scalefac_compress, no scfsi and no preflag bit;
 - LSF scalefactors: scalefac_compress picks the slen of each of four
   partitions and their sizes (nr_of_sfb); preflag is implied at
   scalefac_compress >= 500;
 - the 22.05 kHz scalefactor bands, which also set the Huffman regions;
 - the bit reservoir reaches at most 255 bytes back (main_data_begin).

Each frame's main data fills the bits it is given: a granule's quantizer
scale is searched until its Huffman-coded lines and scalefactors take its
target. Speech frames aim at their budget (0.8-1.2x); pauses, a run of
granules near silence, take a small target, and the bits they leave fill
the reservoir up to 255 bytes, past which they are stuffing. Tail lines
stay within int8: per-channel lines 64 and up after the short-block
reorder, so from line 54 in short blocks (band 4, lines 54-71, is
reordered within itself).

The Huffman code tables, the quantizer, the big-values layout, the table
choice, count1, the bit writer and the block kinds are mp3gen's; the region bounds, and so
part 3's writer, follow the LSF bands here (mp3gen's are MPEG-1's).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import roofline
from . import mp3gen, traffic
from .mp3gen import LONG, PAIR_CODE, PAIR_LEN, PAIR_TABLES, QUAD_CODE, QUAD_LEN, SHORT, START, STOP

SAMPLE_RATE = 22050
SAMPLES_PER_FRAME = 576  # one granule
BYTES_PER_FRAME_PCM = SAMPLES_PER_FRAME * 4  # s16le stereo, the mono channel twice
SIDE_INFO_BYTES = 9  # MPEG-2 mono
HEADER_BYTES = 4
MAX_MDB = 255  # 8-bit main_data_begin
MAX_PART23 = 4095

# ISO/IEC 13818-3 Table 3-B.2 (Layer III, MPEG-2 LSF), kbps -> bitrate_index
BITRATE_INDEX = {8: 1, 16: 2, 24: 3, 32: 4, 40: 5, 48: 6, 56: 7, 64: 8, 80: 9,
                 96: 10, 112: 11, 128: 12, 144: 13, 160: 14}

# ISO/IEC 13818-3 Table B.2, 22.05 kHz
LONG_BANDS = np.array((0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168,
                       200, 238, 284, 336, 396, 464, 522, 576))
SHORT_BANDS = np.array((0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192))
# nr_of_sfb per block class (long, short) and slen table (scalefac_compress
# < 400, < 500, >= 500), ISO/IEC 13818-3 2.4.3.2; short counts are band x window
NR_OF_SFB = (((6, 5, 5, 5), (6, 5, 7, 3), (11, 10, 0, 0)),
             ((9, 9, 9, 9), (9, 9, 12, 6), (18, 18, 0, 0)))
# the largest slen of each partition a slen table can code
SLEN_MAX = ((4, 4, 3, 3), (4, 4, 3, 0), (3, 2, 0, 0))
PRETAB = mp3gen.PRETAB
# per-channel line from which the quantized lines stay within int8 (the
# port's int8 tail starts at line 64, and short blocks reorder band 4 only
# within itself)
TAIL_FROM_LONG = 64
TAIL_FROM_SHORT = 3 * int(SHORT_BANDS[3 * SHORT_BANDS <= 64].max())


def frame_bytes(bitrate_kbps: int, padding: int) -> int:
    return 72 * bitrate_kbps * 1000 // SAMPLE_RATE + padding


def paddings(bitrate_kbps: int, n: int) -> np.ndarray:
    """An encoder's padding: a frame is padded whenever the rest of
    72 * bitrate / rate left over from the frames before reaches a byte."""
    num = 72 * bitrate_kbps * 1000
    rest = (np.arange(1, n + 1) * num) % SAMPLE_RATE
    prev = (np.arange(0, n) * num) % SAMPLE_RATE
    return (rest < prev).astype(np.int64)


def lowpass_line(hz: float) -> int:
    return int(round(hz / (SAMPLE_RATE / 2) * 576))


def scalefac_compress(slen, table: int) -> int:
    """The 9-bit scalefac_compress that codes slen (4 values) in slen
    table 0, 1 or 2 (table 2 implies preflag)."""
    s1, s2, s3, s4 = (int(x) for x in slen)
    if table == 0:
        return ((s1 * 5 + s2) << 4) + (s3 << 2) + s4
    if table == 1:
        return 400 + ((s1 * 5 + s2) << 2) + s3
    return 500 + s1 * 3 + s2


# -- spectra and the Huffman layout -----------------------------------------------


def _line_freq(kind: np.ndarray) -> np.ndarray:
    """Long-block frequency index of each bitstream line, per granule [G, 576]:
    short blocks hold lines band by band, window by window."""
    f_short = np.empty(576, np.int64)
    for sfb in range(13):
        lo, hi = SHORT_BANDS[sfb], SHORT_BANDS[sfb + 1]
        f_short[3 * lo:3 * hi] = 3 * (lo + np.tile(np.arange(hi - lo), 3))
    return np.where((kind == SHORT)[:, None], f_short, np.arange(576))


def region_bounds(kind, big_values, r0, r1):
    """Line bounds [G, 4] of the three big-values regions as a decoder
    reads them: a short block splits at line 36; start and stop blocks at
    LONG_BANDS[8] (region0_count 7); long blocks at the bands the region
    counts name."""
    end = 2 * big_values
    j = r0 + r1 + 2
    b1 = np.where(kind == SHORT, 36, np.where(kind == LONG, LONG_BANDS[np.minimum(r0 + 1, 22)],
                                              LONG_BANDS[8]))
    b2 = np.where(kind == LONG, np.where(j >= 23, 576, LONG_BANDS[np.minimum(j, 22)]), 576)
    b1 = np.minimum(b1, end)
    b2 = np.minimum(np.maximum(b2, b1), end)
    return np.stack([np.zeros_like(b1), b1, b2, end], 1)


def part3_bits(qa, kind):
    """Huffman bits of each granule's magnitudes qa [G, 576], and the side
    info fields they imply (mp3gen.part3_bits with the LSF regions)."""
    bv, n1 = mp3gen._layout(qa)
    nb = np.searchsorted(LONG_BANDS, 2 * bv, side="left")
    r0 = np.clip(np.rint(nb * 0.3).astype(np.int64) - 1, 0, 15)
    r1 = np.clip(np.rint(nb * 0.65).astype(np.int64) - r0 - 2, 0, 7)
    bounds = region_bounds(kind, bv, r0, r1)
    tables, bits = mp3gen._choose_tables(qa, bounds)
    c1, nc = mp3gen._count1(qa, bv, n1)
    fields = {"big_values": bv, "count1_quads": n1, "region0_count": r0,
              "region1_count": r1, "table_select": tables, "count1table_select": c1}
    return bits + nc, fields


# -- a run of frames -----------------------------------------------------------------


def _scalefactors(rng, kind, pause):
    """Per granule: slen table, slen [G, 4], scalefac_compress, preflag and
    part 2's bits. Pauses code no scalefactor; table 2 (preflag) only in
    long blocks, as an encoder sets preflag."""
    g = len(kind)
    short = (kind == SHORT).astype(np.int64)
    table = np.where(short == 1, rng.choice([0, 0, 0, 1], g), rng.choice([0] * 7 + [1, 2, 2], g))
    table = np.where(pause, 0, table)
    limit = np.array(SLEN_MAX)[table]
    slen = np.minimum((rng.random((g, 4)) * (limit + 1)).astype(np.int64), limit)
    slen = np.where(pause[:, None], 0, slen)
    sfc = np.array([scalefac_compress(s, t) for s, t in zip(slen, table)], np.int64)
    nr = np.array(NR_OF_SFB)[short, table]  # [G, 4]
    return table, slen, sfc, (table == 2).astype(np.int64), (nr * slen).sum(1)


def _scalefactor_values(rng, kind, table, slen):
    """sf_l [G, 22] and sf_s [G, 13, 3] as the partitions code them, in
    bitstream order (short: band by band, window by window), and the flat
    values part 2 writes [G] (lists)."""
    g = len(kind)
    sf_l = np.zeros((g, 22), np.int64)
    sf_s = np.zeros((g, 13, 3), np.int64)
    flat = []
    for i in range(g):
        short = int(kind[i] == SHORT)
        nr = NR_OF_SFB[short][table[i]]
        vals = np.concatenate([(rng.random(n) * (1 << int(s))).astype(np.int64)
                               for n, s in zip(nr, slen[i])])
        flat.append((vals, np.repeat(slen[i], nr)))
        if short:
            sf_s[i, :12] = vals.reshape(12, 3)
        else:
            sf_l[i, :21] = vals
    return sf_l, sf_s, flat


def _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg):
    """RMS over a granule of the requantized lines at global gain 210."""
    mag = np.abs(q).astype(np.float64) ** (4.0 / 3.0)
    mult = np.where(sfscale == 1, 1.0, 0.5)[:, None]
    band = np.searchsorted(LONG_BANDS, np.arange(576), side="right") - 1
    exp_long = mult * (sf_l[:, band] + preflag[:, None] * PRETAB[band])
    short_band = np.searchsorted(SHORT_BANDS * 3, np.arange(576), side="right") - 1
    lo = SHORT_BANDS[short_band]
    win = (np.arange(576) - 3 * lo) // (SHORT_BANDS[short_band + 1] - lo)
    exp_short = mult * sf_s[:, short_band, win] + 2.0 * np.take_along_axis(
        sbg, np.broadcast_to(win, q.shape), 1)
    exp = np.where((kind == SHORT)[:, None], exp_short, exp_long)
    return np.sqrt(np.mean((mag * 2.0 ** -exp) ** 2, axis=1))


def _pauses(rng, n_frames, run_frames, pause_share):
    """One pause a run: round(pause_share * run_frames) granules at a start
    drawn in the run."""
    pause = np.zeros(n_frames, bool)
    for f in range(0, n_frames, run_frames):
        n = min(run_frames, n_frames - f)
        k = min(n, int(round(pause_share * run_frames)))
        at = f + int(rng.integers(n - k + 1))
        pause[at:at + k] = True
    return pause


def make_run_fields(rng: np.random.Generator, bitrate_kbps: int, n_frames: int, *,
                    lowpass_hz: float, short_share: float, fricative_share: float,
                    pause_share: float, loudness_rms: float, pause_rms: float,
                    run_frames: int | None = None):
    """n_frames mono frames whose bit reservoir restarts (main_data_begin 0)
    every run_frames frames (never, by default) -> (bytes, frame starts
    [n_frames + 1], the fields written for each granule). fricative_share:
    the share of speech granules whose lines sit at 4-9 kHz; pause_share: the
    share of granules in pauses, at RMS pause_rms; loudness_rms: the RMS of
    the requantized lines of speech (full scale 1)."""
    run_frames = run_frames or n_frames
    fresh = np.arange(n_frames) % run_frames == 0
    G = n_frames
    kind = np.concatenate([
        mp3gen._block_kinds(rng, min(run_frames, n_frames - f), short_share, 0.0)
        for f in range(0, n_frames, run_frames)])
    pause = _pauses(rng, n_frames, run_frames, pause_share)

    # spectral shape: voiced granules fall with frequency (a slope per run
    # and granule), fricatives hold a band of 2-4 kHz centred at 4-9 kHz;
    # Laplacian lines, the lowpass
    freq = _line_freq(kind)
    slope = rng.uniform(1.0, 1.5) + rng.normal(0, 0.08, G)
    voiced = (1.0 + freq / 6.0) ** -slope[:, None]
    hz = freq * (SAMPLE_RATE / 2 / 576)
    centre, width = rng.uniform(4000, 9000, G), rng.uniform(1000, 2000, G)
    hiss = np.exp(-(((hz - centre[:, None]) / width[:, None]) ** 2))
    fricative = (rng.random(G) < fricative_share) & ~pause
    shape = np.where(fricative[:, None], hiss, voiced) * np.abs(rng.laplace(0, 1, (G, 576)))
    shape[freq >= lowpass_line(lowpass_hz)] = 0

    table, slen, sfc, preflag, p2 = _scalefactors(rng, kind, pause)

    # targets: the reservoir, simulated on the targets themselves
    pad = np.concatenate([paddings(bitrate_kbps, min(run_frames, n_frames - f))
                          for f in range(0, n_frames, run_frames)])
    slot = np.array([frame_bytes(bitrate_kbps, p) - HEADER_BYTES - SIDE_INFO_BYTES
                     for p in pad])
    pos = np.concatenate([[0], np.cumsum(slot)])
    want = slot * 8 * np.where(pause, rng.uniform(0.03, 0.12, G), rng.uniform(0.8, 1.2, G))
    target = np.zeros(G, np.int64)
    end = 0  # bits, in the main-data stream
    for f in range(n_frames):
        start = pos[f] if fresh[f] else max(-(-end // 8), pos[f] - MAX_MDB)
        avail = (pos[f] + slot[f] - start) * 8
        target[f] = min(int(want[f]), avail, MAX_PART23)
        end = start * 8 + target[f]

    # the quantizer scale: the largest whose bits fit the target
    tail_from = np.where(kind == SHORT, TAIL_FROM_SHORT, TAIL_FROM_LONG)
    budget = target - p2
    lo = np.full(G, 1.0 / 64)
    hi = np.full(G, 4096.0)
    for _ in range(13):
        mid = np.sqrt(lo * hi)
        bits, _f = part3_bits(mp3gen._quantize(mid, shape, tail_from), kind)
        ok = bits <= budget
        lo = np.where(ok, mid, lo)
        hi = np.where(ok, hi, mid)
    qa = mp3gen._quantize(lo, shape, tail_from)
    bits, fields = part3_bits(qa, kind)
    assert (bits <= budget).all()
    q = qa * np.where(rng.random((G, 576)) < 0.5, -1, 1)

    sf_l, sf_s, flat = _scalefactor_values(rng, kind, table, slen)
    sfscale = (rng.random(G) < 0.1).astype(np.int64)
    sbg = np.where((kind == SHORT)[:, None], rng.choice([0, 0, 0, 1, 2], (G, 3)), 0)
    rms_210 = _rms_at_gain_210(kind, q, sf_l, sf_s, preflag, sfscale, sbg)
    level = np.where(pause, pause_rms, loudness_rms) * 10 ** (rng.normal(0, 3, G) / 20)
    gg = np.clip(np.rint(210 + 4 * np.log2(level / np.maximum(rms_210, 1e-30))), 0, 255)
    gg = np.where(qa.any(1), gg, 0).astype(np.int64)

    gcs = [dict(kind=int(kind[i]), q=q[i], sfc=int(sfc[i]), slen=slen[i], table=int(table[i]),
                sf_l=sf_l[i], sf_s=sf_s[i], sf_flat=flat[i], preflag=int(preflag[i]),
                sfscale=int(sfscale[i]), sbg=sbg[i], gg=int(gg[i]), pause=bool(pause[i]),
                big_values=int(fields["big_values"][i]), n1=int(fields["count1_quads"][i]),
                r0=int(fields["region0_count"][i]), r1=int(fields["region1_count"][i]),
                tables=fields["table_select"][i], c1=int(fields["count1table_select"][i]),
                part23=int(p2[i] + bits[i]))
           for i in range(G)]
    data, starts = _assemble(bitrate_kbps, pad, slot, pos, gcs, fresh)
    return data, starts, gcs


# -- the bitstream ---------------------------------------------------------------


def _part3(b: mp3gen._Bits, gc) -> None:
    """The granule's big values, region by region, then its count1 quads."""
    q, bv = gc["q"], gc["big_values"]
    bounds = region_bounds(np.array([gc["kind"]]), np.array([bv]), np.array([gc["r0"]]),
                           np.array([gc["r1"]]))[0]
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


def _side_info(mdb: int, gc) -> bytes:
    b = mp3gen._Bits()
    b.put([mdb, 0], [8, 1])  # main_data_begin, one private bit (mono)
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
    assert len(bits) == 8 * SIDE_INFO_BYTES
    return np.packbits(bits).tobytes()


def _assemble(bitrate_kbps, pad, slot, pos, gcs, fresh):
    n_frames = len(slot)
    stream = np.zeros(8 * int(pos[-1]), np.uint8)  # the main-data space, in bits
    frames = []
    end = 0
    for f, gc in enumerate(gcs):
        start = int(pos[f]) if fresh[f] else max(-(-end // 8), int(pos[f]) - MAX_MDB)
        mdb = int(pos[f]) - start
        assert 0 <= mdb <= MAX_MDB
        b = mp3gen._Bits()
        vals, widths = gc["sf_flat"]
        b.put(vals, widths)  # part 2
        _part3(b, gc)
        assert b.total() == gc["part23"], (b.total(), gc["part23"])
        bits = b.bits()
        stream[8 * start: 8 * start + len(bits)] = bits
        end = 8 * start + len(bits)
        assert end <= 8 * int(pos[f] + slot[f])
        header = (0xFFF << 20) | (1 << 17) | (1 << 16) \
            | (BITRATE_INDEX[bitrate_kbps] << 12) | (int(pad[f]) << 9) \
            | (3 << 6) | (1 << 2)  # MPEG-2, Layer III, no CRC, 22.05 kHz, mono
        frames.append((header.to_bytes(4, "big"), _side_info(mdb, gc)))
    data = np.packbits(stream).tobytes()
    out, starts = [], [0]
    for f, (h, si) in enumerate(frames):
        out += [h, si, data[int(pos[f]):int(pos[f] + slot[f])]]
        starts.append(starts[-1] + HEADER_BYTES + SIDE_INFO_BYTES + int(slot[f]))
    return b"".join(out), np.array(starts)


# -- streams for a cell --------------------------------------------------------


@dataclass
class Stream(traffic.Stream):
    """A mono LSF stream: 576 samples a frame at 22,050 Hz, decoded to
    s16le stereo (its one channel twice)."""

    @property
    def seconds(self) -> float:
        return self.frames * SAMPLES_PER_FRAME / SAMPLE_RATE

    @property
    def pcm_bytes(self) -> int:
        return self.frames * BYTES_PER_FRAME_PCM


def frame_work(gcs) -> tuple[np.ndarray, np.ndarray]:
    """The chain's work on each frame (benchmark/roofline.py): the
    operations of its one channel, and the bytes of its main data read and
    of its stereo PCM written (the second channel is a copy)."""
    q = np.stack([g["q"] for g in gcs])[:, None]
    short = np.array([[g["kind"] == SHORT] for g in gcs])
    ops = roofline.granule_ops(q, short, np.zeros_like(short), np.zeros(len(gcs), bool))
    bits = np.array([[g["part23"]] for g in gcs])
    nbytes = roofline.granule_bytes(bits) + SAMPLES_PER_FRAME * 2
    return ops.sum(1).astype(np.float64), nbytes.sum(1)


def make_pool(cfg: dict, rng: np.random.Generator) -> list[traffic.Run]:
    """cfg["pool"] runs of cfg["pool"] frames each, each with its own
    reservoir."""
    n_runs = cfg["pool"]["runs_per_bitrate"]
    run_frames = cfg["pool"]["frames_per_run"]
    data, starts, gcs = make_run_fields(
        rng, cfg["bitrate_kbps"], n_runs * run_frames, run_frames=run_frames,
        lowpass_hz=cfg["lowpass_hz"], short_share=cfg["short_share"],
        fricative_share=cfg["fricative_share"], pause_share=cfg["pause_share"], loudness_rms=cfg["loudness_rms"],
        pause_rms=cfg["pause_rms"])
    ops, nbytes = frame_work(gcs)
    runs = []
    for r in range(n_runs):
        a, b = r * run_frames, (r + 1) * run_frames
        s = starts[a:b + 1]
        runs.append(traffic.Run(data[s[0]:s[-1]], s - s[0], ops[a:b], nbytes[a:b]))
    return runs


def track_batches(cfg: dict, wl: dict, seed: int) -> list[list[Stream]]:
    """The catalogue's tracks, each cfg["track_frames"] frames composed of
    runs drawn from the pool, in batches of the workload's batch_clips."""
    rng = traffic.rng_for(seed, 1)
    pool = make_pool(cfg, rng)
    n = wl["batch_clips"]
    br = cfg["bitrate_kbps"]
    return [[Stream(**vars(traffic.compose(rng, pool, br, cfg["track_frames"])))
             for _ in range(n)]
            for _ in range(cfg["catalogue_tracks"] // n)]
