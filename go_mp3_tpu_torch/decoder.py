"""The port's Decoder: go_mp3_tpu.Decoder with its device DSP on PyTorch.

Parsing stays the C++ parser's (go_mp3_tpu/native); each chunk of up to 128
granules goes through the packed int16 interface to ops.kernels.decode_chunk
(K1 -> K2 -> K3 on CUDA, the plain chain on the CPU), with the DSP state
kept on the device. read, seek, length and the rest are inherited.

Only sources the native parser takes whole are accepted: bytes and seekable
binary files. Anything else raises MP3Error.
"""

from __future__ import annotations

import io
from typing import BinaryIO

import numpy as np
import torch

from go_mp3_tpu import decoder as _base
from go_mp3_tpu.bitstream.frameheader import FrameHeader
from go_mp3_tpu.bitstream.parser import FrameReader
from go_mp3_tpu.consts import SAMPLES_PER_GR, SIDE_WIDTH, MP3Error
from go_mp3_tpu.native import lib as native

from .device import resolve_device
from .ops.granule import init_state, state_from_numpy, state_to_numpy
from .ops.kernels import decode_chunk

__all__ = ["Decoder", "MP3Error"]


class _NativeStream(_base._NativeStream):
    """C++ parse -> the port's chunk decode, with the state on `device`."""

    def __init__(self, data: bytes, device: torch.device):
        self._np = np
        self._data = data
        self._parser = native.NativeParser(data)
        self._index_stream = native.index_stream
        self._NativeParser = native.NativeParser
        self._dsp_kind = "device"
        self._device = device
        self._state = init_state(1, device)

    def reset_state(self) -> None:
        self._state = init_state(1, self._device)

    def _decode_granules(self, want: int) -> bytes | None:
        want = min(want, self.CHUNK)
        spectra = np.zeros((self.CHUNK, 1152), np.int16)
        side = np.zeros((self.CHUNK, SIDE_WIDTH), np.int16)
        n = self._parse_packed(spectra[:want], side[:want])
        if n == 0:
            return None
        dev = self._device
        packed = (
            torch.from_numpy(spectra)[None].to(dev),
            torch.from_numpy(side)[None].to(dev),
        )
        valid = torch.tensor([n], dtype=torch.int32, device=dev)
        pcm, self._state = decode_chunk(packed, self._state, valid)
        return pcm[0, : n * SAMPLES_PER_GR].cpu().numpy().tobytes()


def _read_whole(reader) -> bytes:
    if isinstance(reader, io.BytesIO):
        return reader.getvalue()[reader.tell():]
    try:
        seekable = bool(reader.seekable())
    except (AttributeError, OSError):
        seekable = False
    if not seekable:
        raise MP3Error("mp3: the torch decoder needs bytes or a seekable source")
    start = reader.tell()
    data = reader.read()
    reader.seek(start)
    return data


class Decoder(_base.Decoder):
    """A decoded MP3 stream whose DSP runs on `device` (default CUDA)."""

    def __init__(
        self, reader: BinaryIO | bytes, device: torch.device | str | None = None
    ):
        # The native-parser branch of go_mp3_tpu/decoder.py:57-112; the base
        # __init__ cannot be called, since it builds a JAX backend.
        device = resolve_device(device)
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(bytes(reader))
        data = _read_whole(reader)
        if not data or not native.available():
            raise MP3Error("mp3: native parser unavailable for this source")
        self._native = _NativeStream(data, device)
        self._frame_reader = FrameReader()  # reset by seek()
        self._backend_name = "device"
        self._dsp = _base._NullBackend()
        self._buf = bytearray()
        self._pos = 0
        self._length = _base.INVALID_LENGTH
        self._frame_starts: list[int] = []
        self._bytes_per_frame = 0
        self._at_end = False
        self._frame_overhead = 38
        self._mdb_window = 511

        if not self._decode_more():
            raise MP3Error("mp3: no decodable frame found")
        self._sample_rate = self._native.sample_rate()
        self._have_frame = True
        starts, bpf, _sr = self._native.index()
        self._frame_starts = list(starts)
        self._bytes_per_frame = bpf
        self._length = int(bpf * len(starts))
        if self._frame_starts:
            first = self._frame_starts[0]
            word = int.from_bytes(data[first : first + 4], "big")
            self._set_warmup_params(FrameHeader(word))

    @property
    def device(self) -> torch.device:
        return self._native._device

    def checkpoint(self) -> dict:
        """As go_mp3_tpu.Decoder.checkpoint on its device backend: the
        state travels as numpy [2,32,18] / [2,16,64] f32, so a checkpoint
        taken here resumes on either package's device backend."""
        store, v_fifo = state_to_numpy(self._native._state)
        return {
            "pos": self._pos,
            "buf": bytes(self._buf),
            "at_end": self._at_end,
            "backend": self._backend_name,
            "parser_offset": self._native._parser.tell(),
            "reservoir": self._native._parser.get_reservoir(),
            "dsp": ("device", store[0], v_fifo[0]),
        }

    def resume(self, ck: dict) -> None:
        if ck["backend"] != self._backend_name or ck["dsp"][0] != "device":
            raise MP3Error("mp3: checkpoint backend mismatch")
        self._pos = ck["pos"]
        self._buf = bytearray(ck["buf"])
        self._at_end = ck["at_end"]
        self._native.restart(ck["parser_offset"])
        self._native._parser.set_reservoir(ck["reservoir"])
        _, store, v_fifo = ck["dsp"]
        self._native._state = state_from_numpy(
            np.asarray(store)[None], np.asarray(v_fifo)[None], self.device
        )
