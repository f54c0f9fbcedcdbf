"""Gapless playback over the port's Decoder: LAME delay/padding-trimmed
decoding.

The reference documents gapless playback as a caller-side composition of the
decoder with lameinfo; this module packages that composition: skip
Info.total_delay() samples at the start and trim Info.total_padding()
samples at the end. decoder_kwargs, `device` among them, go to the Decoder.
"""

from __future__ import annotations

import io
from typing import BinaryIO

from . import lameinfo
from .bitstream.source import Source
from .decoder import Decoder


class GaplessDecoder:
    """A Decoder that yields only the true audio samples of a LAME file."""

    def __init__(self, reader: BinaryIO | bytes, **decoder_kwargs):
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(reader)
        data_start = reader.tell() if reader.seekable() else None
        try:
            self.info = lameinfo.parse_from_reader(_TagSkippingReader(reader))
        except Exception:
            self.info = None
        if data_start is not None:
            reader.seek(data_start)

        self._decoder = Decoder(reader, **decoder_kwargs)
        delay = self.info.total_delay() if self.info else lameinfo.DECODER_DELAY
        padding = self.info.total_padding() if self.info else 0
        self._start_byte = delay * 4
        total = self._decoder.length()
        if total >= 0:
            self._end_byte = max(total - padding * 4, self._start_byte)
        else:
            self._end_byte = -1
        if total >= 0:
            self._decoder.seek(self._start_byte)
        self._emitted = 0

    @property
    def decoder(self) -> Decoder:
        return self._decoder

    def sample_rate(self) -> int:
        return self._decoder.sample_rate()

    def length(self) -> int:
        """Trimmed PCM byte count (or -1 when unknown)."""
        if self._end_byte < 0:
            return -1
        return self._end_byte - self._start_byte

    def sample_count(self) -> int:
        n = self.length()
        return n // 4 if n >= 0 else -1

    def duration(self) -> float:
        n = self.length()
        if n < 0:
            return -1.0
        return n / (self._decoder.sample_rate() * 4)

    def read(self, n: int = -1) -> bytes:
        if self._end_byte < 0:
            return self._decoder.read(n)
        remaining = self.length() - self._emitted
        if remaining <= 0:
            return b""
        if n is None or n < 0 or n > remaining:
            n = remaining
        out = self._decoder.read(n)
        self._emitted += len(out)
        return out

    def read_all(self) -> bytes:
        chunks = []
        while True:
            c = self.read(1 << 20)
            if not c:
                break
            chunks.append(c)
        return b"".join(chunks)


class _TagSkippingReader:
    """Present `reader` with leading ID3v2/ID3v1 tags skipped (lameinfo needs
    the stream positioned at the first frame)."""

    def __init__(self, reader: BinaryIO):
        self._src = Source(reader)
        self._src.skip_tags()

    def read(self, n: int) -> bytes:
        data, _ = self._src.read_full(n)
        return data
