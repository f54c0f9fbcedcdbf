"""The port's public streaming decoder, its DSP on PyTorch.

A pull-based PCM stream (read/seek) over bytes or any binary file-like
object, with the JAX package's parameters, sources and backends plus a
keyword-only `device`: frame indexing for length and duration,
byte-accurate seeking with a warm-up re-decode, checkpoint and resume.
Output is 16-bit little-endian stereo (4 bytes a sample), mono duplicated.

 - backend="device" on bytes or a seekable binary file: the C++ parser
   takes the stream whole, and each chunk of up to 128 granules goes
   through the packed int16 interface (_NativeStream);
 - backend="device" on a non-seekable reader (a pipe, a socket): the C++
   streaming parser, fed in bounded pieces; length() is -1 and seek
   raises NotSeekableError (_StreamingNativeStream);
 - backend="device" with use_native=False, or without the native library:
   the pure-Python parser, whose frames models.pipeline.StreamDecoder
   stages as GranuleBatches (_DeviceBackend);
 - backend="exact": the C++ parse and the C++ DSP that replicates the
   reference decoder's float32 operation order (bit-exact, no device);
 - backend="golden": the numpy float64 oracle (golden/) on the pure-Python
   parse path (no device).
The device paths run ops.kernels.decode_chunk (the chain kernel on CUDA,
the plain chain on the CPU) with the DSP state kept on `device`.
"""

from __future__ import annotations

import io
import os
import threading
from typing import BinaryIO

import numpy as np
import torch

from . import spans
from .bitstream.bits import BitReader
from .bitstream.frameheader import FrameHeader, read_header
from .bitstream.parser import FrameReader, ParsedFrame
from .bitstream.source import Source
from .consts import (
    SAMPLES_PER_GR,
    SIDE_WIDTH,
    EOFError_,
    MP3Error,
    SyncSearchLimitError,
    UnexpectedEOFError,
)
from .device import resolve_device
from .golden import GoldenDecoder
from .models.pipeline import StreamDecoder
from .native import lib as native
from .ops.granule import DecodeState, init_state, state_from_numpy, state_to_numpy
from .ops.kernels import decode_chunk
from .utils.state import checkpoint_from_bytes, checkpoint_to_bytes

__all__ = ["Decoder", "MP3Error", "NotSeekableError"]

INVALID_LENGTH = -1
GRANULE_BYTES = SAMPLES_PER_GR * 4  # a granule's PCM: 576 stereo 16-bit samples


class NotSeekableError(MP3Error):
    def __init__(self) -> None:
        super().__init__("mp3: seek not supported on non-seekable source")


def _device_state(state) -> tuple:
    # copies: on the CPU the arrays would share the state's memory, and a
    # native stream's state after a seek is the shared zero state
    store, v_fifo = state_to_numpy(state)
    return ("device", store[0].copy(), v_fifo[0].copy())


_ZERO_STATES: dict[torch.device, DecodeState] = {}


def _zero_state(device: torch.device) -> DecodeState:
    """One stream's zero DSP state on `device` (an indexed device on CUDA),
    made once per device and shared: the chain never writes its input
    state, it writes a new one."""
    state = _ZERO_STATES.get(device)
    if state is None:
        state = _ZERO_STATES[device] = init_state(1, device)
    return state


_IDLE_WORKERS: list[native.ParseWorker] = []  # the pool's idle workers, the latest last
_WORKERS_LOCK = threading.Lock()


def _take_worker() -> native.ParseWorker:
    """A native stream's prefetch worker from the process's one pool: the
    worker that went idle last (its thread likely still spinning), or a new
    one (the pool grows to the number of prefetches in flight at once)."""
    with _WORKERS_LOCK:
        return _IDLE_WORKERS.pop() if _IDLE_WORKERS else native.ParseWorker()


def _give_worker(worker: native.ParseWorker) -> None:
    """Back to the pool; a worker of the process this one was forked from,
    which has no thread here, is dropped."""
    if not worker.foreign():
        with _WORKERS_LOCK:
            _IDLE_WORKERS.append(worker)


def _forget_workers() -> None:
    """In a forked child: fork copies no thread, so the pool starts empty
    (native's own hook, registered first, has marked its workers foreign)."""
    global _WORKERS_LOCK
    _WORKERS_LOCK = threading.Lock()
    _IDLE_WORKERS.clear()


os.register_at_fork(after_in_child=_forget_workers)


def _indexed(device: torch.device | None) -> torch.device | None:
    """`device` with its index where it names CUDA without one."""
    if device is not None and device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Decoder:
    """A decoded MP3 stream whose DSP runs on `device` (None means CUDA,
    and raises where there is none; "cpu" runs the plain chain). `device`
    is not used by backend="exact" or backend="golden".

    Not safe for concurrent use; wrap with a lock if shared across
    threads."""

    def __init__(
        self,
        reader: BinaryIO | bytes,
        backend: str = "device",
        readahead_frames: int = 64,
        use_native: bool | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        """use_native: parse with the C++ host parser. None = auto (on when
        available)."""
        with spans.span("gomp3.decoder.open"):
            self._open(reader, backend, readahead_frames, use_native, device)

    def _open(self, reader, backend, readahead_frames, use_native, device) -> None:
        if backend not in ("device", "exact", "golden"):
            raise MP3Error(f"mp3: unknown DSP backend {backend!r}")
        self._device = resolve_device(device) if backend == "device" else None
        if isinstance(reader, (bytes, bytearray)):
            reader = io.BytesIO(reader)
        self._native: _NativeStream | None = None
        if use_native is not False and backend != "golden":
            self._native = _maybe_native_stream(reader, backend, self._device)
            if self._native is None and (use_native is True or backend == "exact"):
                raise MP3Error("mp3: native parser unavailable for this source")
        self._source = Source(reader)
        self._frame_reader = FrameReader()
        self._backend_name = backend
        self._readahead = max(1, readahead_frames)
        self._dsp = None  # the native stream decodes
        if backend == "golden":  # always the pure-Python parse
            self._dsp = _GoldenBackend()
        elif self._native is None:
            self._dsp = _DeviceBackend(self._device)
        self._buf = bytearray()
        self._pos = 0  # decoded-byte position
        self._length = INVALID_LENGTH
        self._frame_starts: list[int] = []
        self._bytes_per_frame = 0
        self._sample_rate = 0
        self._have_frame = False  # a previous frame exists (reservoir warm)
        self._at_end = False  # set by a seek at/past the end of the stream
        # Seek warm-up geometry, refined from the first frame's header
        # (_set_warmup_params). Defaults are the safe maxima: 38 = 4 header
        # + 2 CRC + 32 side info; 511 = the 9-bit MPEG-1 main_data_begin.
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

    # -- decode-ahead ----------------------------------------------------------
    def _read_one_frame(self) -> ParsedFrame | None:
        """The next frame; None at the end of the audio (EOF, trailing junk)."""
        try:
            f = self._frame_reader.read(self._source, self._source.pos)
        except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
            return None
        if not self._have_frame:
            self._sample_rate = f.header.sampling_frequency_value()
            self._set_warmup_params(f.header)
            self._have_frame = True
        return f

    def _set_warmup_params(self, header: FrameHeader) -> None:
        """Seek warm-up geometry from the first frame's header. The overhead
        always budgets the 2 CRC bytes (it only deepens the warm-up); the
        backreference window is 255 for MPEG-2, 511 for MPEG-1."""
        self._frame_overhead = 4 + 2 + header.side_info_size
        self._mdb_window = 255 if header.low_sampling_frequency else 511

    def _read_frames(self, n: int) -> bool:
        """Parse and decode up to n frames of the pure-Python path into the
        buffer; False if there was none."""
        frames = []
        for _ in range(n):
            f = self._read_one_frame()
            if f is None:
                break
            frames.append(f)
        if not frames:
            return False
        self._buf += self._dsp.decode(frames)
        return True

    def _decode_more(self, shortfall: int = 0) -> bool:
        """Decode into the buffer; False if nothing was left. `shortfall`,
        the bytes a read still lacks, sizes the native path's decode after
        a seek (_NativeStream.decode_more)."""
        if self._native is None:
            return self._read_frames(self._readahead)
        pcm = self._native.decode_more(shortfall)
        if pcm is None:
            return False
        self._buf += pcm
        return True

    # -- io.Reader -------------------------------------------------------------
    def read(self, n: int = -1) -> bytes:
        """Up to n bytes of PCM (all that remain if n < 0); b'' at the end."""
        if n is None or n < 0:
            chunks = []
            while c := self.read(1 << 20):
                chunks.append(c)
            return b"".join(chunks)
        with spans.span("gomp3.decoder.read"):
            while len(self._buf) < n:
                if self._at_end or not self._decode_more(n - len(self._buf)):
                    break
            take = min(n, len(self._buf))
            out = bytes(self._buf[:take])
            del self._buf[:take]
            self._pos += take
            return out

    def read_all(self) -> bytes:
        return self.read(-1)

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[: len(data)] = data
        return len(data)

    # -- io.Seeker -------------------------------------------------------------
    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        """Byte-accurate seek in the decoded PCM stream. Samples are 4-byte
        aligned; seek to multiples of 4 to stay on sample boundaries.

        The seek restarts the parse a few frames before the target (the
        warm-up, _warmup_depth) and parses those frames; a parse error at
        the first of them raises here. With the C++ parser it decodes
        nothing: the next read decodes the warm-up frames and its own
        granules in one decode and drops the warm-up's PCM, and a
        checkpoint() before that read first decodes the warm-up alone. The
        pure-Python parse path decodes the warm-up here."""
        if offset == 0 and whence == io.SEEK_CUR:
            return self._pos
        with spans.span("gomp3.decoder.seek"):
            return self._seek(offset, whence)

    def _seek(self, offset: int, whence: int) -> int:
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()
        if whence == io.SEEK_SET:
            npos = offset
        elif whence == io.SEEK_CUR:
            npos = self._pos + offset
        elif whence == io.SEEK_END:
            npos = self._length + offset
        else:
            raise MP3Error("mp3: invalid whence")

        self._pos = max(npos, 0)
        self._buf.clear()
        if self._native is not None:
            self._native.reset_state()
        else:
            self._frame_reader.reset()
            self._dsp.reset()
        self._have_frame = False
        if self._pos >= self._length:  # at or past the end: reads return b""
            self._at_end = True
            return npos
        self._at_end = False

        f = self._pos // self._bytes_per_frame
        k = self._warmup_depth(f)
        spans.count("gomp3.decoder.warmup_frames", k)
        drop = k * self._bytes_per_frame + self._pos % self._bytes_per_frame
        if self._native is not None:
            self._native.restart(self._frame_starts[f - k])
            self._native.pend_frames(k + 1, self._bytes_per_frame, drop)
        else:
            self._source.seek(self._frame_starts[f - k])
            if self._read_frames(k + 1):
                del self._buf[:drop]
        return npos

    def _warmup_depth(self, f: int) -> int:
        """How many frames before target frame f to decode and discard so
        the seek lands bit-identical to a linear decode. Frame f's PCM
        depends on frames f-1 (IMDCT overlap, polyphase FIFO) and f-2 (the
        overlap term inside f-1's FIFO rows); both need exact spectra, so
        the warm frames before f-2 must cover f-2's backreference window:
        their main-data bytes must reach the stream's main_data_begin
        maximum. Walks to frame 0 on pathological low-bitrate streams."""
        if f < 2:
            return f  # decode from frame 0
        need, ov, k = self._mdb_window, self._frame_overhead, 2
        while (
            f - k > 0
            and self._frame_starts[f - 2] - self._frame_starts[f - k]
            < need + ov * (k - 2)
        ):
            k += 1
        return k

    # -- checkpoint / resume ---------------------------------------------------
    def checkpoint(self) -> dict:
        """The full decode state for a sample-exact resume on a Decoder over
        the same stream and backend: plain bytes and numpy values (the
        device state as [2,32,18] / [2,16,64] float32, so a checkpoint of
        either package's device backend resumes on the other's). Warm-up
        frames a seek left parsed are decoded first, so the checkpoint is
        the one a decode of them at the seek would give."""
        if self._native is not None:
            self._buf += self._native.settle()
        ck: dict = {
            "pos": self._pos,
            "buf": bytes(self._buf),
            "at_end": self._at_end,
            "backend": self._backend_name,
        }
        if self._native is not None:
            ck["parser_offset"], ck["reservoir"] = self._native.position()
            ck["dsp"] = self._native._staging.state()
            return ck
        prev = self._frame_reader.prev_bits
        ck["reservoir"] = prev.vec if prev is not None else b""
        ck["source_pos"] = self._source.pos
        ck["have_frame"] = self._have_frame
        ck["dsp"] = self._dsp.state()
        return ck

    def checkpoint_bytes(self) -> bytes:
        """checkpoint() in a stable wire format (utils.state)."""
        return checkpoint_to_bytes(self.checkpoint())

    def resume_bytes(self, data: bytes) -> None:
        """Restore a checkpoint_bytes() snapshot (same stream, same backend)."""
        self.resume(checkpoint_from_bytes(data))

    def resume(self, ck: dict) -> None:
        """Restore a checkpoint() snapshot (same stream, same backend)."""
        if ck["backend"] != self._backend_name:
            raise MP3Error("mp3: checkpoint backend mismatch")
        self._pos = ck["pos"]
        self._buf = bytearray(ck["buf"])
        self._at_end = ck["at_end"]
        _, store, v_fifo = ck["dsp"]
        if self._native is not None:
            self._native.restart(ck["parser_offset"])
            self._native._parser.set_reservoir(ck["reservoir"])
            self._native._staging.set_state(store, v_fifo)
            return
        self._source.seek(ck["source_pos"])
        self._frame_reader.prev_bits = (
            BitReader(ck["reservoir"]) if ck["reservoir"] else None
        )
        self._have_frame = ck["have_frame"]
        self._dsp.set_state(store, v_fifo)

    # -- metadata / navigation -------------------------------------------------
    def _ensure_frame_starts_and_length(self) -> None:
        """Index pass over the whole file, headers only."""
        if self._length != INVALID_LENGTH or not self._source.seekable():
            return
        pos = self._source.seek(0, io.SEEK_CUR)
        self._source.rewind()
        self._source.skip_tags()
        total = 0
        while True:
            try:
                h, start = read_header(self._source, self._source.pos)
            except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
                break
            self._frame_starts.append(start)
            self._bytes_per_frame = h.bytes_per_frame
            total += self._bytes_per_frame
            self._source.seek(h.frame_size() - 4, io.SEEK_CUR)
        self._length = total
        self._source.seek(pos, io.SEEK_SET)

    def sample_rate(self) -> int:
        """Sample rate in Hz, from the first frame."""
        return self._sample_rate

    def length(self) -> int:
        """Total decoded size in bytes, or -1 if not seekable."""
        return self._length

    def bytes_per_frame(self) -> int:
        return self._bytes_per_frame

    def duration(self) -> float:
        """Total duration in seconds, or -1.0 if unknown."""
        if self._length == INVALID_LENGTH:
            return -1.0
        return self._length / (self._sample_rate * 4)

    def position(self) -> float:
        """Current position in seconds."""
        return self._pos / (self._sample_rate * 4)

    def tell(self) -> int:
        return self._pos

    def remaining(self) -> float:
        d = self.duration()
        return -1.0 if d < 0 else d - self.position()

    def progress(self) -> float:
        if self._length == INVALID_LENGTH:
            return -1.0
        return self._pos / self._length if self._length else 0.0

    def sample_position(self) -> int:
        return self._pos // 4

    def sample_count(self) -> int:
        return -1 if self._length == INVALID_LENGTH else self._length // 4

    def seek_to_sample(self, sample: int) -> None:
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()
        self.seek(min(max(sample, 0), self.sample_count()) * 4, io.SEEK_SET)

    def skip(self, delta_seconds: float) -> None:
        self.seek_to_time(self.position() + delta_seconds)

    def seek_to_time(self, t: float) -> None:
        """Seek to an absolute time in seconds, clamped and 4-byte aligned."""
        if self._length == INVALID_LENGTH:
            raise NotSeekableError()
        t = min(max(t, 0.0), self.duration())
        self.seek(int(t * self._sample_rate * 4) & ~3, io.SEEK_SET)


def _maybe_native_stream(reader, dsp: str, device: torch.device | None):
    """The native path: the whole-buffer parse for bytes and seekable
    sources (length and seeking), the streaming parser for the others
    (bounded memory, no length); None where the native library is missing
    or a seekable source cannot be read whole."""
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
            return _StreamingNativeStream(reader, dsp, device)
        try:
            start = reader.tell()
            data = reader.read()
            reader.seek(start)
        except (OSError, ValueError):
            return None
    return _NativeStream(data, dsp, device) if data else None


class _NativeStream:
    """C++ parse -> the port's chunk decode on `device` (dsp "device") or
    the exact C++ DSP (dsp "exact"), with the Decoder's frame-oriented
    contract: decode-ahead, restart at a byte offset for seeks.

    Every decode is one path: decode_more parses granules into a row set
    of the stream's `_staging` (the DSP kind's two row sets and DSP, chosen
    at the open: _Staging on the device, _ExactDsp for the C++ DSP) and
    runs the DSP once on them, in as many rows as granules rounded up to
    RUN (at most CHUNK). With nothing pending it takes up to CHUNK
    granules, the readahead. A seek's pend_frames parses the warm-up
    frames into the rows and decodes nothing; the decode_more after it
    parses whole frames on into the same rows until they cover the
    warm-up's bytes and the read's shortfall (a fold), and cuts the
    warm-up's bytes from its PCM. settle() decodes pending rows alone
    (checkpoint() calls it first); a restart or a state reset drops them.

    A readahead starts a prefetch before its device call: a native worker
    thread of the process's one pool (native.ParseWorker, which runs no
    Python and so never waits for the interpreter lock that the device
    call drops and takes around each torch call) parses the next readahead
    into the other row set, which the last device call released (its
    blocking copy down ran after its copy up), while this call and the
    reads that drain its PCM run on the caller's thread. The next readahead
    joins the worker and takes those rows (a parse error of the prefetch
    raises there), so the caller parses only the first readahead after an
    open or a fold. A fold starts no prefetch: the read after a seek joins
    nothing. Nor does a non-seekable source, whose reader stays on the
    caller's thread (_StreamingNativeStream). While a prefetch is in flight
    the parser is the worker's: position() and sample_rate() give what it
    held when the prefetch started, and a restart waits for nothing: it
    makes its own parser and leaves the old one to the dropped prefetch,
    whose row set the next prefetch takes only after closing that parser
    (NativeParser.close waits for a parse in flight). A state reset leaves
    a prefetch alone: it parses what the next readahead would, whatever
    the DSP state. In a process forked from the one that started a
    prefetch, the worker's thread is the parent's alone: the join parses
    again on the caller's thread from the offset and reservoir recorded at
    the start, and the worker never returns to the child's pool."""

    CHUNK = 128  # granules per decode, a multiple of RUN
    RUN = 4  # K5's longest run of granules: a decode's rows are a multiple

    def __init__(self, data: bytes, dsp: str, device: torch.device | None, parser=None):
        self._data = data
        self._parser = native.NativeParser(data) if parser is None else parser
        if dsp == "device":
            self._staging = _Staging(self.CHUNK, _indexed(device))
        else:
            self._staging = _ExactDsp(self.CHUNK)
        self._rows = 0  # the row set the caller's thread parses into
        self._ahead: native.ParseWorker | None = None  # the last prefetch not joined
        self._mark = None  # (offset, reservoir, sample rate) as the prefetch in flight began
        self._stale = None  # the parser a restart left to a dropped prefetch
        self._drop_pending()

    def sample_rate(self) -> int:
        return self._parser.sample_rate if self._mark is None else self._mark[2]

    def position(self) -> tuple[int, bytes]:
        """The parser's byte offset and reservoir, less a prefetch in
        flight: what a checkpoint resumes from."""
        if self._mark is not None:
            return self._mark[0], self._mark[1]
        return self._parser.tell(), self._parser.get_reservoir()

    def index(self):
        return native.index_stream(self._data)

    def _drop_pending(self) -> None:
        self._pending = None  # (granules, granules a frame) parsed at a seek
        self._drop = 0  # PCM bytes still to cut from the next decodes

    def reset_state(self) -> None:
        self._drop_pending()
        self._staging.reset()

    def restart(self, byte_offset: int) -> None:
        self._drop_pending()
        if self._mark is None:
            self._parser.close()
        else:  # the prefetch in flight parses with it: closed by the next prefetch
            self._stale, self._mark = self._parser, None
        self._parser = native.NativeParser(self._data, byte_offset)

    def _parse(self, into, *rows) -> int:
        """into(parser, *rows): the granules the parser wrote to `rows`; 0
        at the end of the audio."""
        return into(self._parser, *rows)

    def _parse_rows(self, lo: int, hi: int) -> int:
        """Granules the C++ parse wrote to rows [lo, hi) of the caller's set."""
        with spans.span("gomp3.decoder.parse"):
            return self._staging.parse(self._parse, self._rows, lo, hi)

    def _prefetch(self) -> None:
        """Start the next readahead's parse into the other row set on a
        worker of the pool, first waiting for a dropped prefetch that may
        still write that set."""
        if self._ahead is not None:
            self._drop_ahead()
        parser = self._parser
        self._mark = (parser.tell(), parser.get_reservoir(), parser.sample_rate)
        worker = self._ahead = _take_worker()
        self._staging.parse(lambda into, *rows: worker.start(into, parser, *rows),
                            self._rows ^ 1, 0, self.CHUNK)

    def _join(self) -> int:
        """The granules the prefetch in flight parsed, its row set now the
        caller's and its worker back in the pool; its parse error raises
        here, and its parse time counts in the parse span's totals. In a
        forked child the parse runs here instead, from where the prefetch
        started."""
        worker, self._ahead = self._ahead, None
        (offset, reservoir, _), self._mark = self._mark, None
        self._rows ^= 1
        if worker.foreign():
            self._parser.close()  # the parent's thread may have cut its parse
            self._parser = native.NativeParser(self._data, offset)
            self._parser.set_reservoir(reservoir)
            return self._parse_rows(0, self.CHUNK)
        try:
            with spans.span("gomp3.decoder.prefetch_wait"):
                n, seconds = worker.join()
        finally:
            _give_worker(worker)
        spans.record("gomp3.decoder.parse", seconds)
        if n:
            spans.count("gomp3.decoder.prefetched")
        return n

    def _drop_ahead(self) -> None:
        """Wait for a dropped prefetch, its rows and its parse error unread,
        closing the parser a restart left to it; its worker back in the
        pool."""
        worker, self._ahead = self._ahead, None
        self._stale.close()  # waits for the parse (in a forked child, leaves it)
        self._stale = None
        _give_worker(worker)

    def _capacity(self, frames: int, gpf: int) -> int:
        """Rows to parse `frames` whole frames of `gpf` granules into, at
        most CHUNK. The native parse loop keeps 2 output slots free per
        iteration (a frame may yield 2 granules), so a capacity of N gives
        only N-1 granules of single-granule (MPEG-2) frames: pad."""
        return min(frames * gpf + (1 if gpf == 1 else 0), self.CHUNK)

    def pend_frames(self, n_frames: int, bytes_per_frame: int, drop: int) -> None:
        """Parse up to n_frames frames (at most CHUNK granules) into the
        rows for the next decode, and cut `drop` bytes from the PCM of the
        decodes that follow. Decodes nothing. A parse error in the first
        frame raises here (the C++ parser stops short at a later one, and
        the next decode parses on from there). Called after a restart."""
        gpf = max(1, bytes_per_frame // GRANULE_BYTES)
        n = self._parse_rows(0, self._capacity(n_frames, gpf))
        self._pending = (n, gpf) if n else None
        self._drop = drop

    def decode_more(self, shortfall: int = 0) -> bytes | None:
        """The next decode's PCM; None at the end of the audio. With rows
        pending from a seek: those rows and whole frames after them until
        they cover the bytes to cut and `shortfall` more (a seek fold);
        else the readahead, the prefetch's rows where one is in flight,
        which starts the next prefetch."""
        readahead = self._pending is None
        if not readahead:
            (n, gpf), self._pending = self._pending, None
            granules = -(-(self._drop + shortfall) // GRANULE_BYTES)
            cap = self._capacity(-(-granules // gpf), gpf)
            spans.count("gomp3.decoder.seek_folds")
            if cap - n >= 2:  # fewer free rows parse nothing
                n += self._parse_rows(n, cap)
        elif self._mark is not None:
            n = self._join()
        else:
            n = self._parse_rows(0, self.CHUNK)
        if n == 0:
            return None
        rows = self._rows
        if readahead:
            self._prefetch()
        pcm = self._staging.decode(rows, n, -(-n // self.RUN) * self.RUN)
        if not self._drop:
            return pcm
        cut = min(self._drop, len(pcm))  # a warm-up past this decode's PCM cuts on
        self._drop -= cut
        return pcm[cut:]

    def settle(self) -> bytes:
        """Decode what a seek left pending: its rows alone, and where its
        warm-up was longer than CHUNK granules, readaheads until the
        warm-up's bytes are cut. Their PCM, less those bytes."""
        out = b""
        while self._pending is not None or self._drop:
            pcm = self.decode_more()
            if pcm is None:
                self._drop = 0
                break
            out += pcm
        return out


class _Staging:
    """A native stream's device DSP: the buffers of its device calls, made
    once at the stream's open and reused by every call, the chain call and
    the DSP state. One host block: two row sets that the C++ parser writes
    (a prefetch parses into one while a call ships the other) and the PCM
    that comes back; and one device twin of a row set and the PCM. On CUDA
    the host block is pinned, taken from torch's caching host allocator, so
    a stream opened after another one closed reuses its block; on the CPU
    it is plain memory and the copies are plain copies, the same path. A
    state reset points the state at the device's shared zero state.

    A row set, in int16 words: `valid` (int32) and padding to 16 bytes,
    then side [rows, SIDE_WIDTH] and spectra [rows, 1152]; after the two
    sets, the PCM [rows * 576, 2]. The device block is a row set and the
    PCM. A call of r rows copies its set up to spectra row r in one copy:
    `valid`, every side row (rows past r unread) and r rows of spectra."""

    HEAD = 8  # words before the side rows: `valid` and padding

    def __init__(self, rows: int, device: torch.device):
        self._device = device
        self.pinned = device.type == "cuda"
        self._spectra0 = self.HEAD + rows * SIDE_WIDTH
        self._pcm0 = self._spectra0 + rows * 1152  # a row set's words
        pcm = rows * SAMPLES_PER_GR * 2
        self._host = torch.empty(2 * self._pcm0 + pcm, dtype=torch.int16,
                                 pin_memory=self.pinned)
        self._dev = torch.empty(self._pcm0 + pcm, dtype=torch.int16, device=device)
        block = self._host.numpy()
        sets = [block[i * self._pcm0:(i + 1) * self._pcm0] for i in range(2)]
        self.side_np = [s[self.HEAD:self._spectra0].reshape(rows, SIDE_WIDTH) for s in sets]
        self.spectra_np = [s[self._spectra0:].reshape(rows, 1152) for s in sets]
        self._valid_np = [s[:2].view(np.int32) for s in sets]
        self._pcm_np = block[2 * self._pcm0:]
        self._pcm = self._host[2 * self._pcm0:]
        self._valid = self._dev[:2].view(torch.int32)
        self._calls: dict[tuple, tuple] = {}  # (set, rows) -> the views a call takes
        self.reset()

    def reset(self) -> None:
        self._state = _zero_state(self._device)

    def state(self) -> tuple:
        return _device_state(self._state)

    def set_state(self, store, v_fifo) -> None:
        self._state = state_from_numpy(
            np.asarray(store)[None], np.asarray(v_fifo)[None], self._device
        )

    def parse(self, parse, which: int, lo: int, hi: int) -> int:
        """Granules the packed C++ parse wrote to rows [lo, hi) of set `which`."""
        return parse(native.NativeParser.parse_packed_into,
                     self.spectra_np[which][lo:hi], self.side_np[which][lo:hi])

    def _views(self, which: int, rows: int) -> tuple:
        v = self._calls.get((which, rows))
        if v is None:
            up = self._spectra0 + rows * 1152
            d, h = self._dev, which * self._pcm0
            v = self._calls[which, rows] = (
                d[:up], self._host[h:h + up],
                (d[self._spectra0:up].view(1, rows, 1152),
                 d[self.HEAD:self.HEAD + rows * SIDE_WIDTH].view(1, rows, SIDE_WIDTH)),
                d[self._pcm0:self._pcm0 + rows * SAMPLES_PER_GR * 2].view(
                    1, rows * SAMPLES_PER_GR, 2))
        return v

    def decode(self, which: int, n: int, rows: int) -> bytes:
        """One device call over the first `rows` rows of set `which`, n of
        them granules: their PCM. Rows [n, rows) are cleared (`valid` masks
        them; the parser wrote rows [0, n) whole); then valid = n and the
        rows go up in one copy (async on CUDA), the chain writes the PCM
        into the device block, and the PCM comes down into the host block
        in one blocking copy_, which into pinned memory is one async copy
        on the current stream and one synchronize of it, both inside
        torch. That wait also frees the set: the copy up has run when it
        returns, so the next parse into it, the caller's or a prefetch's,
        may write it."""
        with spans.span("gomp3.decoder.h2d"):
            self.spectra_np[which][n:rows] = 0
            self.side_np[which][n:rows] = 0
            self._valid_np[which][0] = n
            dst, src, packed, out = self._views(which, rows)
            dst.copy_(src, non_blocking=True)
        with spans.span("gomp3.decoder.launch"):
            pcm, self._state = decode_chunk(packed, self._state, self._valid, out)
        with spans.span("gomp3.decoder.d2h"):
            words = n * SAMPLES_PER_GR * 2
            self._pcm[:words].copy_(pcm.view(-1)[:words])
        spans.count("gomp3.decoder.granules", n)
        spans.count("gomp3.decoder.rows", rows)
        if self.pinned:
            spans.count("gomp3.decoder.pinned_calls")
        return self._pcm_np[:words].tobytes()


class _ExactDsp:
    """A native stream's exact DSP: native.NativeDsp, which replicates the
    reference decoder's float32 operation order, and two sets of the four
    row arrays the C++ parser writes for it (a prefetch parses into one
    while the DSP reads the other). A parse zeroes the rows it parses
    into: only the packed parse is known to write every word of a
    granule."""

    def __init__(self, rows: int):
        self._dsp = native.NativeDsp()
        self._rows = [(
            np.zeros((rows, 2, 576), np.int16),
            np.zeros((rows, 2, 22), np.int32),
            np.zeros((rows, 2, 39), np.int32),
            np.zeros((rows, native.META_WIDTH), np.int32),
        ) for _ in range(2)]

    def reset(self) -> None:
        self._dsp.reset()

    def state(self) -> tuple:
        return ("exact", *self._dsp.get_state())

    def set_state(self, store, v_fifo) -> None:
        self._dsp.set_state(store, v_fifo)

    def parse(self, parse, which: int, lo: int, hi: int) -> int:
        """Granules the C++ parse wrote to rows [lo, hi) of set `which`,
        zeroed first."""
        rows = [a[lo:hi] for a in self._rows[which]]
        for a in rows:
            a.fill(0)
        return parse(native.NativeParser.parse_into, *rows)

    def decode(self, which: int, n: int, rows: int) -> bytes:
        """The PCM of the first n rows' granules of set `which` (`rows` is
        the device's call size; the C++ DSP takes the granules alone)."""
        return self._dsp.decode(*(a[:n] for a in self._rows[which])).tobytes()


class _StreamingNativeStream(_NativeStream):
    """The native path for sources that cannot be read whole (pipes,
    sockets, unbounded streams): the C++ parser owns a compacting buffer
    fed on demand, so memory stays bounded. No length, no seek, and no
    prefetch: the reader is read on the caller's thread alone."""

    FEED = 1 << 16  # bytes per reader.read()

    def __init__(self, reader, dsp: str, device: torch.device | None):
        self._reader = reader
        super().__init__(b"", dsp, device, native.StreamingNativeParser())

    def _parse(self, into, *rows) -> int:
        """As _NativeStream._parse, feeding the parser from the reader
        while it asks for more; 0 at the end of the reader."""
        while (n := into(self._parser, *rows)) == 0:
            if self._parser.eof:
                return 0
            chunk = self._reader.read(self.FEED)
            self._parser.feed(chunk or b"", eof=not chunk)
        return n

    def _prefetch(self) -> None:
        pass

    def index(self):
        return None  # not materializable: no length

    def restart(self, byte_offset: int) -> None:
        raise NotSeekableError()


class _DeviceBackend:
    """The pure-Python parse path's DSP: a StreamDecoder on `device`."""

    def __init__(self, device: torch.device) -> None:
        self._sd = StreamDecoder(device=device)

    def reset(self) -> None:
        self._sd.reset()

    def decode(self, frames: list[ParsedFrame]) -> bytes:
        for f in frames:
            self._sd.feed_frame(f)
        return self._sd.decode_pending(flush=True)

    def state(self) -> tuple:
        return _device_state(self._sd.state)

    def set_state(self, store, v_fifo) -> None:
        self._sd.state = state_from_numpy(
            np.asarray(store)[None], np.asarray(v_fifo)[None], self._sd.device
        )


class _GoldenBackend:
    """The numpy float64 oracle, frame by frame."""

    def __init__(self) -> None:
        self._gd = GoldenDecoder()

    def reset(self) -> None:
        self._gd = GoldenDecoder()

    def decode(self, frames: list[ParsedFrame]) -> bytes:
        return b"".join(
            self._gd.decode_frame(f.header, f.side_info, f.main_data) for f in frames
        )

    def state(self) -> tuple:
        return ("golden", self._gd.store.copy(), self._gd.v_fifo.copy())

    def set_state(self, store, v_fifo) -> None:
        self._gd.store = store.copy()
        self._gd.v_fifo = v_fifo.copy()
