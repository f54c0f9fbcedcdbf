# Frozen copy of go_mp3_tpu_torch/bitstream/parser.py at commit 6b659fa, its imports made local.
# sha256 of the original without its relative imports: 7297fea175900f9e92a25f30e60a16cad45de86fd271980dbbc679726d489188
"""Frame-level parsing: header -> CRC -> side info -> main data.

Mirrors go-mp3 internal/frame/frame.go:56-115 (reading and state
carry), without the DSP — spectral output stays integer-valued for the DSP
stages in go_mp3_tpu_torch.ops.
"""

from __future__ import annotations

from dataclasses import dataclass

from .consts import Layer, MP3Error, UnexpectedEOFError, Version
from .bits import BitReader
from .frameheader import FrameHeader, read_header
from .maindata import MainData, read_main_data
from .sideinfo import SideInfo, read_side_info
from .source import Source


@dataclass
class ParsedFrame:
    header: FrameHeader
    side_info: SideInfo
    main_data: MainData
    start_position: int


class FrameReader:
    """Reads successive frames from a source, carrying the bit reservoir."""

    def __init__(self) -> None:
        self.prev_bits: BitReader | None = None

    def reset(self) -> None:
        self.prev_bits = None

    def read(self, source: Source, position: int) -> ParsedFrame:
        header, pos = read_header(source, position)
        if header.protection_bit == 0:
            buf, eof = source.read_full(2)  # CRC value is read but not checked
            if len(buf) < 2:
                raise UnexpectedEOFError("read_crc")
        if header.version == Version.MPEG2_5:
            raise MP3Error("mp3: MPEG version 2.5 is not supported")
        if header.layer != Layer.LAYER3:
            raise MP3Error(
                f"mp3: only layer3 (want {int(Layer.LAYER3)}; "
                f"got {int(header.layer)}) is supported"
            )
        side_info = read_side_info(source, header)
        main_data, self.prev_bits = read_main_data(
            source, self.prev_bits, header, side_info
        )
        return ParsedFrame(header, side_info, main_data, pos)
