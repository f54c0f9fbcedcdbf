"""Xing/Info + LAME tag parsing for VBR metadata and gapless playback.

Functional parity with the reference's lameinfo package
(go-mp3 lameinfo/lameinfo.go): frame count, byte count, the
100-entry seek TOC, VBR scale, LAME encoder version, and the 12-bit encoder
delay/padding pair used for gapless trimming. Like the reference this module
is self-contained (its own header math) so it can be used on raw frames
without constructing a decoder.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO

from .consts import MP3Error

FLAG_FRAME_COUNT = 0x0001
FLAG_BYTE_COUNT = 0x0002
FLAG_TOC = 0x0004
FLAG_VBR_SCALE = 0x0008

# Standard MP3 decoder delay in samples (lameinfo.go:86-88)
DECODER_DELAY = 529


class NoXingHeaderError(MP3Error):
    def __init__(self) -> None:
        super().__init__("lameinfo: no Xing/Info header found")


@dataclass
class Info:
    """Parsed LAME/Xing header information (ref: lameinfo.go:20-51)."""

    is_xing: bool = False
    flags: int = 0
    frame_count: int = 0
    byte_count: int = 0
    toc: bytes = b""
    vbr_scale: int = 0
    lame_version: str = ""
    encoder_delay: int = 0
    encoder_padding: int = 0

    @property
    def has_frame_count(self) -> bool:
        return bool(self.flags & FLAG_FRAME_COUNT)

    @property
    def has_byte_count(self) -> bool:
        return bool(self.flags & FLAG_BYTE_COUNT)

    @property
    def has_toc(self) -> bool:
        return bool(self.flags & FLAG_TOC)

    @property
    def has_vbr_scale(self) -> bool:
        return bool(self.flags & FLAG_VBR_SCALE)

    @property
    def has_lame_info(self) -> bool:
        return self.lame_version != ""

    def total_delay(self) -> int:
        """Samples to skip at the start for gapless playback
        (ref: lameinfo.go:92-97)."""
        if not self.has_lame_info:
            return DECODER_DELAY
        return self.encoder_delay + DECODER_DELAY

    def total_padding(self) -> int:
        """Samples to trim from the end for gapless playback
        (ref: lameinfo.go:101-111)."""
        if not self.has_lame_info:
            return 0
        return max(0, self.encoder_padding - DECODER_DELAY)

    def seek_point(self, fraction: float, stream_bytes: int) -> int:
        """Approximate byte offset for a playback fraction using the TOC.

        TOC entries are percentages of the byte stream at each playback
        percent; linear interpolation between entries."""
        if not self.has_toc or len(self.toc) != 100:
            raise MP3Error("lameinfo: no TOC available")
        fraction = min(max(fraction, 0.0), 1.0)
        fx = fraction * 100.0
        i = min(int(fx), 99)
        a = self.toc[i]
        b_val = self.toc[i + 1] if i + 1 < 100 else 256
        pct = a + (b_val - a) * (fx - i)
        return int(pct / 256.0 * stream_bytes)


def _is_lame_version(s: bytes) -> bool:
    """ref: lameinfo.go:273-281."""
    if len(s) < 4:
        return False
    return s[:4] in (b"LAME", b"L3.9", b"Gogo", b"GOGO")


def _side_info_size(mpeg1: bool, mono: bool) -> int:
    if mpeg1:
        return 17 if mono else 32
    return 9 if mono else 17


def parse(frame: bytes) -> Info:
    """Parse the Xing/Info (+LAME) tag out of a complete first frame
    (ref: lameinfo.go:139-270). Raises NoXingHeaderError if absent."""
    if len(frame) < 4:
        raise NoXingHeaderError()
    header = struct.unpack(">I", frame[0:4])[0]
    if (header & 0xFFE00000) != 0xFFE00000:
        raise NoXingHeaderError()
    mpeg_version = (header >> 19) & 0x03
    if mpeg_version == 1:
        raise NoXingHeaderError()
    mono = ((header >> 6) & 0x03) == 3
    offset = 4 + _side_info_size(mpeg_version == 3, mono)

    if len(frame) < offset + 4:
        raise NoXingHeaderError()
    tag = frame[offset : offset + 4]
    if tag not in (b"Xing", b"Info"):
        raise NoXingHeaderError()

    info = Info(is_xing=(tag == b"Xing"))
    pos = offset + 4

    def read_u32() -> int:
        nonlocal pos
        if len(frame) < pos + 4:
            raise NoXingHeaderError()
        v = struct.unpack(">I", frame[pos : pos + 4])[0]
        pos += 4
        return v

    info.flags = read_u32()
    if info.has_frame_count:
        info.frame_count = read_u32()
    if info.has_byte_count:
        info.byte_count = read_u32()
    if info.has_toc:
        if len(frame) < pos + 100:
            raise NoXingHeaderError()
        info.toc = frame[pos : pos + 100]
        pos += 100
    if info.has_vbr_scale:
        info.vbr_scale = read_u32()

    # LAME tag: 9-byte version string, 12 bytes of encoder settings, then
    # 3 bytes packing 12-bit delay | 12-bit padding (ref: lameinfo.go:239-266)
    if len(frame) >= pos + 9:
        version = frame[pos : pos + 9]
        if _is_lame_version(version):
            info.lame_version = version.decode("latin-1")
            delay_off = pos + 9 + 12
            if len(frame) >= delay_off + 3:
                b0, b1, b2 = frame[delay_off : delay_off + 3]
                info.encoder_delay = (b0 << 4) | (b1 >> 4)
                info.encoder_padding = ((b1 & 0x0F) << 8) | b2
    return info


# Bitrates in kbit/s indexed [version_bits][layer_bits][bitrate_index]
# (lameinfo keeps its own tables so it stays standalone; ref
# lameinfo.go:331-362)
_BITRATE_KBPS = {
    # version bits 3 = MPEG-1
    3: {
        1: (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0),
        2: (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384, 0),
        3: (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448, 0),
    },
    # version bits 2 = MPEG-2, 0 = MPEG-2.5 (same Layer II/III rates)
    2: {
        1: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0),
        2: (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160, 0),
        3: (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256, 0),
    },
}
_BITRATE_KBPS[0] = _BITRATE_KBPS[2]

_SAMPLE_RATES = {
    0: (11025, 12000, 8000, 0),
    2: (22050, 24000, 16000, 0),
    3: (44100, 48000, 32000, 0),
}


def _calculate_frame_size(
    version: int, layer: int, bitrate_index: int, sr_index: int, padding: int
) -> int:
    """ref: lameinfo.go:364-384."""
    bitrate = _BITRATE_KBPS[version][layer][bitrate_index] * 1000
    sample_rate = _SAMPLE_RATES[version][sr_index]
    if bitrate == 0 or sample_rate == 0:
        return 0
    if layer == 3:  # Layer I
        return (12 * bitrate // sample_rate + padding) * 4
    if version == 3:  # MPEG-1 Layer II/III
        return 144 * bitrate // sample_rate + padding
    return 72 * bitrate // sample_rate + padding


def parse_from_reader(r: BinaryIO) -> Info:
    """Read the first frame from a stream positioned at a frame boundary and
    parse its Xing/LAME tag (ref: lameinfo.go:288-328)."""
    header_bytes = r.read(4)
    if len(header_bytes) < 4:
        raise MP3Error("lameinfo: short read")
    h = struct.unpack(">I", header_bytes)[0]
    if (h & 0xFFE00000) != 0xFFE00000:
        raise NoXingHeaderError()
    version = (h >> 19) & 0x03
    layer = (h >> 17) & 0x03
    bitrate_index = (h >> 12) & 0x0F
    sr_index = (h >> 10) & 0x03
    padding = (h >> 9) & 0x01
    if version == 1 or layer == 0 or bitrate_index in (0, 15) or sr_index == 3:
        raise NoXingHeaderError()
    frame_size = _calculate_frame_size(version, layer, bitrate_index, sr_index, padding)
    if frame_size < 4:
        raise NoXingHeaderError()
    rest = r.read(frame_size - 4)
    if len(rest) < frame_size - 4:
        raise MP3Error("lameinfo: short read")
    return parse(header_bytes + rest)
