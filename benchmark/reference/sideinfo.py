# Frozen copy of go_mp3_tpu_torch/bitstream/sideinfo.py at commit 6b659fa, its imports made local.
# sha256 of the original without its relative imports: 7ddbd91d90b3fa1b09c13c348ff9befae1dff08bf426debccb2704413411b05e
"""Layer III side-information parsing (MPEG-1: 9/17/32 bytes; MPEG-2: 9/17).

Mirrors go-mp3 internal/sideinfo/sideinfo.go, including the implicit
region counts for window-switched granules (sideinfo.go:129-136) and the
MPEG-2 field-width differences.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .consts import Mode, MP3Error, UnexpectedEOFError
from .bits import BitReader
from .frameheader import FrameHeader
from .source import Source


def _gr_ch(v=0):
    return [[v, v], [v, v]]


@dataclass
class SideInfo:
    main_data_begin: int = 0
    private_bits: int = 0
    scfsi: list = field(default_factory=lambda: [[0] * 4, [0] * 4])  # [ch][band]
    part2_3_length: list = field(default_factory=_gr_ch)  # [gr][ch]
    big_values: list = field(default_factory=_gr_ch)
    global_gain: list = field(default_factory=_gr_ch)
    scalefac_compress: list = field(default_factory=_gr_ch)
    win_switch_flag: list = field(default_factory=_gr_ch)
    block_type: list = field(default_factory=_gr_ch)
    mixed_block_flag: list = field(default_factory=_gr_ch)
    table_select: list = field(
        default_factory=lambda: [[[0] * 3, [0] * 3], [[0] * 3, [0] * 3]]
    )  # [gr][ch][region]
    subblock_gain: list = field(
        default_factory=lambda: [[[0] * 3, [0] * 3], [[0] * 3, [0] * 3]]
    )  # [gr][ch][window]
    region0_count: list = field(default_factory=_gr_ch)
    region1_count: list = field(default_factory=_gr_ch)
    preflag: list = field(default_factory=_gr_ch)
    scalefac_scale: list = field(default_factory=_gr_ch)
    count1_table_select: list = field(default_factory=_gr_ch)
    count1: list = field(default_factory=_gr_ch)  # set by the Huffman driver


# Field widths that differ between MPEG-1 and MPEG-2
# [lsf] -> (main_data_begin, private_mono, private_stereo, scalefac_compress)
_BITS_TO_READ = ((9, 5, 3, 4), (8, 1, 2, 9))


def read_side_info(source: Source, header: FrameHeader) -> SideInfo:
    """Parse side info for one frame (ref: sideinfo.go:66-156)."""
    nch = header.number_of_channels
    framesize = header.frame_size()
    if framesize > 2000:
        raise MP3Error(f"mp3: framesize = {framesize}")
    size = header.side_info_size

    buf, eof = source.read_full(size)
    if len(buf) < size:
        if eof:
            raise UnexpectedEOFError("side_info.read")
        raise MP3Error(f"mp3: couldn't read sideinfo {size} bytes")
    s = BitReader(buf)

    lsf = header.low_sampling_frequency
    mpeg1 = lsf == 0
    btr = _BITS_TO_READ[lsf]

    si = SideInfo()
    si.main_data_begin = s.bits(btr[0])
    if header.mode == Mode.SINGLE_CHANNEL:
        si.private_bits = s.bits(btr[1])
    else:
        si.private_bits = s.bits(btr[2])

    if mpeg1:
        for ch in range(nch):
            for band in range(4):
                si.scfsi[ch][band] = s.bits(1)

    for gr in range(header.granules):
        for ch in range(nch):
            si.part2_3_length[gr][ch] = s.bits(12)
            si.big_values[gr][ch] = s.bits(9)
            si.global_gain[gr][ch] = s.bits(8)
            si.scalefac_compress[gr][ch] = s.bits(btr[3])
            si.win_switch_flag[gr][ch] = s.bits(1)
            if si.win_switch_flag[gr][ch] == 1:
                si.block_type[gr][ch] = s.bits(2)
                si.mixed_block_flag[gr][ch] = s.bits(1)
                for region in range(2):
                    si.table_select[gr][ch][region] = s.bits(5)
                for window in range(3):
                    si.subblock_gain[gr][ch][window] = s.bits(3)
                # Implicit region counts for window-switched granules.
                # Short non-mixed blocks use 8, everything else 7; region1
                # fills the rest (ref: sideinfo.go:129-136).
                if si.block_type[gr][ch] == 2 and si.mixed_block_flag[gr][ch] == 0:
                    si.region0_count[gr][ch] = 8
                else:
                    si.region0_count[gr][ch] = 7
                si.region1_count[gr][ch] = 20 - si.region0_count[gr][ch]
            else:
                for region in range(3):
                    si.table_select[gr][ch][region] = s.bits(5)
                si.region0_count[gr][ch] = s.bits(4)
                si.region1_count[gr][ch] = s.bits(3)
                si.block_type[gr][ch] = 0
                if not mpeg1:
                    si.mixed_block_flag[0][ch] = 0
            if mpeg1:
                si.preflag[gr][ch] = s.bits(1)
            si.scalefac_scale[gr][ch] = s.bits(1)
            si.count1_table_select[gr][ch] = s.bits(1)
    return si
