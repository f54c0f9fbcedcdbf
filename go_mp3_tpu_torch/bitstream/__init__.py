"""Host-side bitstream layer: byte source, bit reader, frame header sync,
side info, bit reservoir, scalefactors and Huffman spectral decode.

Everything here is inherently serial per stream (variable-length codes, the
bit reservoir's backreference into previous frames) and therefore runs on the
host; the output is fixed-shape granule batches consumed by the device DSP in
go_mp3_tpu_torch.ops.
"""

from .bits import BitReader, append
from .frameheader import FrameHeader, read_header
from .maindata import MainData, read_main_data
from .sideinfo import SideInfo, read_side_info
from .source import Source

__all__ = [
    "BitReader",
    "append",
    "FrameHeader",
    "read_header",
    "MainData",
    "read_main_data",
    "SideInfo",
    "read_side_info",
    "Source",
]
