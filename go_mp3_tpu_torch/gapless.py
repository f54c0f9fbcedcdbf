"""Gapless playback over the port's Decoder: go_mp3_tpu.GaplessDecoder
(go_mp3_tpu/gapless.py) with the LAME delay and padding trimmed the same
way, its decoding on the port."""

from __future__ import annotations

import io
from typing import BinaryIO

from go_mp3_tpu import gapless as _base
from go_mp3_tpu import lameinfo

from .decoder import Decoder


class GaplessDecoder(_base.GaplessDecoder):
    """A port Decoder that yields only the true audio samples of a LAME
    file. decoder_kwargs, `device` among them, go to the port's Decoder;
    read, length and the rest are go_mp3_tpu's."""

    def __init__(self, reader: BinaryIO | bytes, **decoder_kwargs):
        # go_mp3_tpu/gapless.py:21-43, which builds go_mp3_tpu's Decoder
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(reader)
        data_start = reader.tell() if reader.seekable() else None
        try:
            self.info = lameinfo.parse_from_reader(_base._TagSkippingReader(reader))
        except Exception:  # no LAME/Xing tag: the decoder delay alone
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
            self._decoder.seek(self._start_byte)
        else:
            self._end_byte = -1
        self._emitted = 0
