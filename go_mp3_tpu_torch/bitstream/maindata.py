"""Main-data layer: bit-reservoir assembly, scalefactor decode, Huffman driver.

Mirrors go-mp3 internal/maindata/maindata.go and huffman.go:
 - the bit reservoir prepends up to main_data_begin bytes of previous frames'
   payload (maindata.go:290-323), with the skip-frame-but-consume-bytes path
   when the reservoir is underfilled,
 - MPEG-1 scalefactors incl. scfsi granule-copy (maindata.go:190-288),
 - MPEG-2 scalefactors via the nSlen2 packed-slen scheme (maindata.go:52-81,
   119-188),
 - the Huffman region driver with the mpg123/ffmpeg-compatible region clamp
   and 4-word overshoot rollback (maindata/huffman.go:27-138).

The spectral output is kept as int32 — raw Huffman magnitudes (linbits and
sign applied) exactly as held in MainData.Is before requantization — which is
the host->TPU interface of this framework.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..consts import (
    SAMPLES_PER_GR,
    SF_BAND_INDICES,
    SF_BAND_INDICES_LONG,
    MP3Error,
    UnexpectedEOFError,
)
from . import huffman
from .bits import BitReader, append
from .frameheader import FrameHeader
from .sideinfo import SideInfo
from .source import Source


@dataclass
class MainData:
    # [gr][ch][sfb] long-block scalefactors
    scalefac_l: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2, 22), dtype=np.int32)
    )
    # [gr][ch][sfb][window] short-block scalefactors
    scalefac_s: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2, 13, 3), dtype=np.int32)
    )
    # [gr][ch][line] raw Huffman spectral values (pre-requantize)
    is_: np.ndarray = field(
        default_factory=lambda: np.zeros((2, 2, SAMPLES_PER_GR), dtype=np.int32)
    )


# MPEG-1 scalefactor bit widths (slen1, slen2) per scalefac_compress
# (ISO 11172-3 Table B.6; ref maindata.go:39-42).
SCALEFAC_SIZES_MPEG1 = (
    (0, 0), (0, 1), (0, 2), (0, 3), (3, 0), (1, 1), (1, 2), (1, 3),
    (2, 1), (2, 2), (2, 3), (3, 1), (3, 2), (3, 3), (4, 2), (4, 3),
)

# MPEG-2 scalefactor band-group counts [block_class][d][group]
# (ISO 13818-3; ref maindata.go:44-50).
SCALEFAC_SIZES_MPEG2 = (
    ((6, 5, 5, 5), (6, 5, 7, 3), (11, 10, 0, 0),
     (7, 7, 7, 0), (6, 6, 6, 3), (8, 8, 5, 0)),
    ((9, 9, 9, 9), (9, 9, 12, 6), (18, 18, 0, 0),
     (12, 12, 12, 0), (12, 9, 9, 6), (15, 12, 9, 0)),
    ((6, 9, 9, 9), (6, 9, 12, 6), (15, 18, 0, 0),
     (6, 15, 12, 0), (6, 12, 9, 6), (6, 18, 9, 0)),
)


def _init_n_slen2() -> list[int]:
    """MPEG-2 packed slen table for 'normal'/intensity modes
    (ref: maindata.go:54-81)."""
    n_slen2 = [0] * 512
    for i in range(4):
        for j in range(3):
            n = j + i * 3
            n_slen2[n + 500] = i | (j << 3) | (2 << 12) | (1 << 15)
    for i in range(5):
        for j in range(5):
            for k in range(4):
                for n_l in range(4):
                    n = n_l + k * 4 + j * 16 + i * 80
                    n_slen2[n] = i | (j << 3) | (k << 6) | (n_l << 9)
    for i in range(5):
        for j in range(5):
            for k in range(4):
                n = k + j * 4 + i * 20
                n_slen2[n + 400] = i | (j << 3) | (k << 6) | (1 << 12)
    return n_slen2


N_SLEN2 = _init_n_slen2()


def _assemble_reservoir(
    source: Source, prev: BitReader | None, size: int, offset: int
) -> BitReader:
    """Build this frame's main-data bit buffer: `offset` tail bytes of the
    previous reservoir + `size` fresh payload bytes (ref: maindata.go:290-323).

    When the previous reservoir holds fewer than `offset` bytes the reference
    does NOT skip the frame: it decodes from the full previous buffer plus the
    fresh bytes, position reset to 0 (maindata.go:295-308 returns
    bits.Append(prev, buf) with a nil error). We reproduce that."""
    if size > 1500:
        raise MP3Error(f"mp3: size = {size}")
    if prev is not None and offset > prev.len_in_bytes():
        buf, eof = source.read_full(size)
        if len(buf) < size:
            if eof:
                raise UnexpectedEOFError("maindata.read (1)")
            raise MP3Error("mp3: maindata read failed")
        return append(prev, buf)
    vec = b""
    if prev is not None:
        vec = prev.tail(offset)
    buf, eof = source.read_full(size)
    if len(buf) < size:
        if eof:
            raise UnexpectedEOFError("maindata.read (2)")
        raise MP3Error("mp3: maindata read failed")
    return BitReader(vec + buf)


def read_main_data(
    source: Source,
    prev: BitReader | None,
    header: FrameHeader,
    side_info: SideInfo,
) -> tuple[MainData, BitReader]:
    """Assemble the reservoir and decode scalefactors + spectral data for one
    frame (ref: maindata.go:85-117)."""
    framesize = header.frame_size()
    if framesize > 2000:
        raise MP3Error(f"mp3: framesize = {framesize}")
    main_data_size = framesize - header.side_info_size - 4
    if header.protection_bit == 0:
        main_data_size -= 2

    m = _assemble_reservoir(source, prev, main_data_size, side_info.main_data_begin)
    if header.low_sampling_frequency == 1:
        md = _scale_factors_mpeg2(m, header, side_info)
    else:
        md = _scale_factors_mpeg1(m, header, side_info)
    return md, m


def _scale_factors_mpeg2(
    m: BitReader, header: FrameHeader, si: SideInfo
) -> MainData:
    """MPEG-2 LSF scalefactor decode (ref: maindata.go:119-188)."""
    nch = header.number_of_channels
    md = MainData()
    for ch in range(nch):
        part2_start = m.bit_pos_total()
        slen = N_SLEN2[si.scalefac_compress[0][ch]]
        si.preflag[0][ch] = (slen >> 15) & 0x1

        n = 0
        if si.block_type[0][ch] == 2:
            n += 1
            if si.mixed_block_flag[0][ch] != 0:
                n += 1

        scale_factors: list[int] = []
        d = (slen >> 12) & 0x7
        for i in range(4):
            num = slen & 0x7
            slen >>= 3
            cnt = SCALEFAC_SIZES_MPEG2[n][d][i]
            if num > 0:
                for _ in range(cnt):
                    scale_factors.append(m.bits(num))
            else:
                scale_factors.extend([0] * cnt)
        n = (n << 1) + 1
        scale_factors.extend([0] * n)

        if len(scale_factors) == 22:
            md.scalefac_l[0][ch][:22] = scale_factors
        else:
            md.scalefac_s[0][ch] = np.asarray(
                scale_factors[:39], dtype=np.int32
            ).reshape(13, 3)

        _read_huffman(m, header, si, md, part2_start, 0, ch)
    return md


def _scale_factors_mpeg1(
    m: BitReader, header: FrameHeader, si: SideInfo
) -> MainData:
    """MPEG-1 scalefactor decode incl. scfsi copy (ref: maindata.go:190-288)."""
    nch = header.number_of_channels
    md = MainData()
    for gr in range(2):
        for ch in range(nch):
            part2_start = m.bit_pos_total()
            slen1, slen2 = SCALEFAC_SIZES_MPEG1[si.scalefac_compress[gr][ch]]
            if si.win_switch_flag[gr][ch] == 1 and si.block_type[gr][ch] == 2:
                if si.mixed_block_flag[gr][ch] != 0:
                    for sfb in range(8):
                        md.scalefac_l[gr][ch][sfb] = m.bits(slen1)
                    for sfb in range(3, 12):
                        nbits = slen1 if sfb < 6 else slen2
                        for win in range(3):
                            md.scalefac_s[gr][ch][sfb][win] = m.bits(nbits)
                else:
                    for sfb in range(12):
                        nbits = slen1 if sfb < 6 else slen2
                        for win in range(3):
                            md.scalefac_s[gr][ch][sfb][win] = m.bits(nbits)
            else:
                # Four scfsi bands: 0-5, 6-10, 11-15, 16-20. scfsi=1 on gr1
                # copies gr0's values (ref: maindata.go:235-278).
                bands = ((0, 6, slen1), (6, 11, slen1), (11, 16, slen2), (16, 21, slen2))
                for band_idx, (lo, hi, slen) in enumerate(bands):
                    if si.scfsi[ch][band_idx] == 0 or gr == 0:
                        for sfb in range(lo, hi):
                            md.scalefac_l[gr][ch][sfb] = m.bits(slen)
                    elif si.scfsi[ch][band_idx] == 1 and gr == 1:
                        for sfb in range(lo, hi):
                            md.scalefac_l[1][ch][sfb] = md.scalefac_l[0][ch][sfb]
            _read_huffman(m, header, si, md, part2_start, gr, ch)
    return md


def _read_huffman(
    m: BitReader,
    header: FrameHeader,
    si: SideInfo,
    md: MainData,
    part2_start: int,
    gr: int,
    ch: int,
) -> None:
    """Spectral decode for one granule/channel (ref: maindata/huffman.go:27-138)."""
    is_gr = md.is_[gr][ch]
    if si.part2_3_length[gr][ch] == 0:
        is_gr[:] = 0
        si.count1[gr][ch] = 0
        return

    bit_pos_end = part2_start + si.part2_3_length[gr][ch] - 1

    if si.win_switch_flag[gr][ch] == 1 and si.block_type[gr][ch] == 2:
        region1_start = 36
        region2_start = SAMPLES_PER_GR
    else:
        sfreq = header.sampling_frequency
        lsf = header.low_sampling_frequency
        long_bands = SF_BAND_INDICES[lsf][sfreq][SF_BAND_INDICES_LONG]
        i = si.region0_count[gr][ch] + 1
        if i < 0 or i >= len(long_bands):
            raise MP3Error(f"mp3: read_huffman failed: invalid index i: {i}")
        region1_start = long_bands[i]
        j = si.region0_count[gr][ch] + si.region1_count[gr][ch] + 2
        if j < 0:
            raise MP3Error(f"mp3: read_huffman failed: invalid index j: {j}")
        # Clamp overlong region counts to the table end, matching
        # mpg123/ffmpeg (ref: maindata/huffman.go:58-63).
        region2_start = SAMPLES_PER_GR if j >= len(long_bands) else long_bands[j]

    # big_values region: two spectral lines per codeword
    table_select = si.table_select[gr][ch]
    big_values2 = si.big_values[gr][ch] * 2
    if big_values2 > SAMPLES_PER_GR:
        raise MP3Error(f"mp3: is_pos was too big: {SAMPLES_PER_GR}")
    is_pos = 0
    while is_pos < big_values2:
        if is_pos < region1_start:
            table_num = table_select[0]
        elif is_pos < region2_start:
            table_num = table_select[1]
        else:
            table_num = table_select[2]
        x, y, _, _ = huffman.decode(m, table_num)
        is_gr[is_pos] = x
        is_pos += 1
        is_gr[is_pos] = y
        is_pos += 1

    # count1 region: quadruples until the bit budget is exhausted
    table_num = si.count1_table_select[gr][ch] + 32
    while is_pos <= 572 and m.bit_pos_total() <= bit_pos_end:
        x, y, v, w = huffman.decode(m, table_num)
        is_gr[is_pos] = v
        is_pos += 1
        if is_pos >= SAMPLES_PER_GR:
            break
        is_gr[is_pos] = w
        is_pos += 1
        if is_pos >= SAMPLES_PER_GR:
            break
        is_gr[is_pos] = x
        is_pos += 1
        if is_pos >= SAMPLES_PER_GR:
            break
        is_gr[is_pos] = y
        is_pos += 1

    # Overshoot rollback: drop the last quadruple if we read past the budget
    # (ref: maindata/huffman.go:119-125).
    if m.bit_pos_total() > bit_pos_end + 1:
        is_pos -= 4
    if is_pos < 0:
        is_pos = 0

    si.count1[gr][ch] = is_pos
    if is_pos < SAMPLES_PER_GR:
        is_gr[is_pos:] = 0
    m.set_pos(bit_pos_end + 1)
