"""The port's Decoder: go_mp3_tpu.Decoder with its device DSP on PyTorch.

The parameters, sources and backends of go_mp3_tpu.Decoder
(go_mp3_tpu/decoder.py:48-117), plus a keyword-only `device`:
 - backend="device" on bytes or a seekable binary file: the C++ parser
   takes the stream whole, and each chunk of up to 128 granules goes
   through the packed int16 interface (_NativeStream);
 - backend="device" on a non-seekable reader (a pipe, a socket): the C++
   streaming parser, fed in bounded pieces; length() is -1 and seek
   raises NotSeekableError (_StreamingNativeStream);
 - backend="device" with use_native=False, or without the native library:
   the pure-Python parser, whose frames models.pipeline.StreamDecoder
   stages as GranuleBatches (_DeviceBackend);
 - backend="exact": go_mp3_tpu's own C++ parse and exact C++ DSP, which
   need no device and no JAX.
The device paths run ops.kernels.decode_chunk (K1 -> K2 -> K3 on CUDA, the
plain chain on the CPU) with the DSP state kept on `device`. read, seek,
length and the rest are inherited.

backend="golden" is go_mp3_tpu's numpy float64 oracle
(go_mp3_tpu/ops/reference_dsp.py, loaded without JAX by golden.py) on the
pure-Python parse path, as in go_mp3_tpu; like "exact", it needs no device.
"""

from __future__ import annotations

import io
from typing import BinaryIO

import numpy as np
import torch

from go_mp3_tpu import decoder as _base
from go_mp3_tpu.bitstream.bits import BitReader
from go_mp3_tpu.bitstream.frameheader import FrameHeader
from go_mp3_tpu.bitstream.parser import FrameReader, ParsedFrame
from go_mp3_tpu.bitstream.source import Source
from go_mp3_tpu.consts import SAMPLES_PER_GR, SIDE_WIDTH, MP3Error
from go_mp3_tpu.decoder import NotSeekableError
from go_mp3_tpu.native import lib as native

from .device import resolve_device
from .golden import golden_decoder_class
from .models.pipeline import StreamDecoder
from .ops.granule import init_state, state_from_numpy, state_to_numpy
from .ops.kernels import decode_chunk

__all__ = ["Decoder", "MP3Error", "NotSeekableError"]


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


class _StreamingNativeStream(_base._StreamingNativeStream, _NativeStream):
    """The C++ streaming parser (bounded memory, no index, no seek) ->
    the port's chunk decode. Feeding, parsing, index() and restart() are
    the base streaming class's; _decode_granules and reset_state are the
    port's _NativeStream's, which comes next in the MRO."""

    def __init__(self, reader, device: torch.device):
        self._np = np
        self._reader = reader
        self._data = b""
        self._parser = native.StreamingNativeParser()
        self._dsp_kind = "device"
        self._device = device
        self._state = init_state(1, device)


def _maybe_native_stream(reader, device: torch.device):
    """go_mp3_tpu/decoder.py:488-524 with the port's streams: the
    whole-buffer parse for bytes and seekable sources, the streaming parser
    for the others; None where the native library is missing or a seekable
    source cannot be read whole."""
    if not native.available():
        return None
    if isinstance(reader, io.BytesIO):
        data = reader.getvalue()[reader.tell():]
    else:
        try:
            seekable = bool(reader.seekable())
        except (AttributeError, OSError, ValueError):
            seekable = False
        if not seekable:
            return _StreamingNativeStream(reader, device)
        try:
            start = reader.tell()
            data = reader.read()
            reader.seek(start)
        except (OSError, ValueError):
            return None
    return _NativeStream(data, device) if data else None


class _DeviceBackend:
    """The pure-Python parse path's DSP (go_mp3_tpu/decoder.py:709-721):
    a StreamDecoder on `device`."""

    def __init__(self, device: torch.device) -> None:
        self._sd = StreamDecoder(device=device)

    def reset(self) -> None:
        self._sd.reset()

    def decode_frames(self, frames: list[ParsedFrame]) -> bytes:
        for f in frames:
            self._sd.feed_frame(f)
        return self._sd.decode_pending(flush=True)


class _GoldenBackend(_base._GoldenBackend):
    """go_mp3_tpu/decoder.py:724-739 with the oracle loaded without JAX;
    decode_frames is the base class's. `_gd` is the GoldenDecoder, which
    the base checkpoint and resume read and write."""

    def __init__(self) -> None:
        self._gd = golden_decoder_class()()

    def reset(self) -> None:
        self._gd = golden_decoder_class()()


class Decoder(_base.Decoder):
    """A decoded MP3 stream whose DSP runs on `device` (None means CUDA,
    and raises where there is none; "cpu" runs the plain chain). `device`
    is not used by backend="exact" or backend="golden"."""

    def __init__(
        self,
        reader: BinaryIO | bytes,
        backend: str = "device",
        readahead_frames: int = 64,
        use_native: bool | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        # go_mp3_tpu/decoder.py:57-117; the base __init__ cannot be called,
        # since it builds JAX backends
        if backend not in ("device", "exact", "golden"):
            raise MP3Error(f"mp3: unknown DSP backend {backend!r}")
        self._device = resolve_device(device) if backend == "device" else None
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(reader)
        self._native = None
        if use_native is not False and backend != "golden":
            if backend == "device":
                self._native = _maybe_native_stream(reader, self._device)
            else:  # go_mp3_tpu's exact streams are JAX-free
                self._native = _base._maybe_native_stream(reader, dsp="exact")
            if self._native is None and (use_native is True or backend == "exact"):
                raise MP3Error("mp3: native parser unavailable for this source")
        self._source = Source(reader)
        self._frame_reader = FrameReader()
        self._backend_name = backend
        self._readahead = max(1, readahead_frames)
        if backend == "golden":  # always the pure-Python parse, as in JAX's
            self._dsp = _GoldenBackend()
        elif self._native is None and backend == "device":
            self._dsp = _DeviceBackend(self._device)
        else:  # the native streams decode; nothing to build here
            self._dsp = _base._NullBackend()
        self._buf = bytearray()
        self._pos = 0
        self._length = _base.INVALID_LENGTH
        self._frame_starts: list[int] = []
        self._bytes_per_frame = 0
        self._sample_rate = 0
        self._have_frame = False
        self._at_end = False
        self._frame_overhead = 38
        self._mdb_window = 511

        if self._native is not None:
            if not self._decode_more():
                raise MP3Error("mp3: no decodable frame found")
            self._sample_rate = self._native.sample_rate()
            self._have_frame = True
            idx = self._native.index()
            if idx is not None:  # None: a non-seekable source, no length
                starts, bpf, _sr = idx
                self._frame_starts = list(starts)
                self._bytes_per_frame = bpf
                self._length = int(bpf * len(starts))
                if self._frame_starts:
                    first = self._frame_starts[0]
                    word = int.from_bytes(self._native._data[first : first + 4], "big")
                    self._set_warmup_params(FrameHeader(word))
            return

        self._source.skip_tags()
        if not self._decode_more():
            raise MP3Error("mp3: no decodable frame found")
        self._ensure_frame_starts_and_length()

    @property
    def device(self) -> torch.device | None:
        return self._device

    def checkpoint(self) -> dict:
        """As go_mp3_tpu.Decoder.checkpoint, with the same keys on each
        path. The device state travels as numpy [2,32,18] / [2,16,64] f32,
        so a checkpoint taken here resumes on either package's device
        backend, on the same parse path."""
        if self._backend_name != "device":
            return super().checkpoint()
        ck: dict = {
            "pos": self._pos,
            "buf": bytes(self._buf),
            "at_end": self._at_end,
            "backend": self._backend_name,
        }
        if self._native is not None:
            ck["parser_offset"] = self._native._parser.tell()
            ck["reservoir"] = self._native._parser.get_reservoir()
            state = self._native._state
        else:
            prev = self._frame_reader.prev_bits
            ck["reservoir"] = prev.vec if prev is not None else b""
            ck["source_pos"] = self._source.pos
            ck["have_frame"] = self._have_frame
            state = self._dsp._sd.state
        store, v_fifo = state_to_numpy(state)
        ck["dsp"] = ("device", store[0], v_fifo[0])
        return ck

    def resume(self, ck: dict) -> None:
        if self._backend_name != "device":
            return super().resume(ck)
        if ck["backend"] != self._backend_name or ck["dsp"][0] != "device":
            raise MP3Error("mp3: checkpoint backend mismatch")
        self._pos = ck["pos"]
        self._buf = bytearray(ck["buf"])
        self._at_end = ck["at_end"]
        _, store, v_fifo = ck["dsp"]
        state = state_from_numpy(
            np.asarray(store)[None], np.asarray(v_fifo)[None], self._device
        )
        if self._native is not None:
            self._native.restart(ck["parser_offset"])
            self._native._parser.set_reservoir(ck["reservoir"])
            self._native._state = state
            return
        self._source.seek(ck["source_pos"])
        self._frame_reader.prev_bits = (
            BitReader(ck["reservoir"]) if ck["reservoir"] else None
        )
        self._have_frame = ck["have_frame"]
        self._dsp._sd.state = state
