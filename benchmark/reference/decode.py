"""The plain reference decoder: the frozen parser copy, then dsp.StreamDSP.

decode(data) is a linear decode of a whole stream. decode_frames(data,
first, n) gives the PCM of frames [first, first + n) as a linear decode
gives it, from a decode that starts WARM frames earlier: the first two of
those may read main data from before the start (the reservoir reaches at
most 511 bytes back, under two frames at the benchmark's bitrates), and
the next two set the overlap-add and polyphase state, which hold nothing
older than the last granule.
"""

from __future__ import annotations

import io

from .consts import EOFError_
from .dsp import StreamDSP, granules_of
from .frameheader import FrameHeader
from .parser import FrameReader
from .source import Source

WARM = 4
BLOCK = 64  # frames a DSP call


def frame_starts(data: bytes) -> list[int]:
    """Byte offsets of the frames of a stream with no tags or junk."""
    starts, pos = [], 0
    while pos + 4 <= len(data):
        h = FrameHeader(int.from_bytes(data[pos:pos + 4], "big"))
        if not h.is_valid():
            raise ValueError(f"no frame header at byte {pos}")
        starts.append(pos)
        pos += h.frame_size()
    return starts


def _frames(data: bytes, offset: int, n: int | None):
    src = Source(io.BytesIO(data))
    src.seek(offset)
    fr = FrameReader()
    out = []
    while n is None or len(out) < n:
        try:
            out.append(fr.read(src, src.pos))
        except EOFError_:
            break
    return out


def _run(frames, precision: str) -> bytes:
    dsp = StreamDSP(precision)
    parts = [dsp.decode(granules_of(frames[i:i + BLOCK]))
             for i in range(0, len(frames), BLOCK)]
    return b"".join(p.tobytes() for p in parts)


def decode(data: bytes, precision: str = "float64") -> bytes:
    """s16le stereo PCM of the whole stream."""
    return _run(_frames(data, 0, None), precision)


def decode_frames(data: bytes, first: int, n: int, starts: list[int] | None = None,
                  precision: str = "float64") -> bytes:
    """s16le stereo PCM of frames [first, first + n) (fewer at the end)."""
    starts = frame_starts(data) if starts is None else starts
    lead = min(first, WARM)
    frames = _frames(data, starts[first - lead], lead + n)
    pcm = _run(frames, precision)
    per_frame = len(pcm) // max(1, len(frames))
    return pcm[lead * per_frame:]


def pcm_span(data: bytes, byte_offset: int, nbytes: int, starts: list[int],
             bytes_per_frame: int, precision: str = "float64") -> bytes:
    """The linear decode's PCM bytes [byte_offset, byte_offset + nbytes)."""
    first = byte_offset // bytes_per_frame
    last = -(-(byte_offset + nbytes) // bytes_per_frame)
    pcm = decode_frames(data, first, last - first, starts, precision)
    skip = byte_offset - first * bytes_per_frame
    return pcm[skip:skip + nbytes]
