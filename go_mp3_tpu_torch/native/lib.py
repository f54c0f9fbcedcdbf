"""ctypes bindings for the native host parser (libmp3parse.so).

The native parser emits granule-batch arrays directly (spectra, scalefactors,
packed meta), removing the Python parse+pack cost from the decode path. Falls
back gracefully: `available()` is False when the library cannot be built,
and callers keep using the pure-Python parser.

The library is built here at first use, with g++, from mp3parse.cpp,
mp3dsp.cpp, synth_window_data.cpp and prefetch.cpp (ParseWorker), into
build/go_mp3_tpu_torch/native-<hash>/ at the repo root. The hash covers the
sources, the flags and the host's CPU (the build is -march=native), so a
library built on another machine is never loaded. It is loaded
RTLD_LOCAL, so another copy of the same C ABI can live in the same process.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from pathlib import Path

import numpy as np

from ..consts import (  # single source
    HEAD_WIDTH,
    META_WIDTH,
    SIDE8_WIDTH,
    SIDE_WIDTH,
    SP8_TAIL_WIDTH,
)

_DIR = Path(__file__).resolve().parent
_BUILD_ROOT = _DIR.parents[1] / "build" / "go_mp3_tpu_torch"
_SOURCES = ("mp3parse.cpp", "mp3dsp.cpp", "synth_window_data.cpp", "prefetch.cpp")
_HEADERS = ("huffman_data.h",)
# -ffp-contract=off: the exact DSP replicates the Go reference's float32
# arithmetic, and Go's amd64 backend never contracts mul+add into FMA;
# letting g++ fuse changes ~200 samples a file by 1 LSB.
_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-fPIC",
          "-shared", "-pthread", "-Wall", "-Wextra"]

# packed sidecar layout (must match mp3parse.cpp gmp_parse_packed emit):
# one int16[SIDE_WIDTH] word vector per granule carrying all metadata +
# scalefactors; words 0..21 mirror the META_* slots, then scalefactors.
SIDE_SFL = 22  # [2][22] long scalefactors at words 22..65
SIDE_SFS = 66  # [2][39] short scalefactors at words 66..143
# int8-quantized layout (gmp_parse_packed8): side8 bytes [0:44] meta LE i16
# words, [44:88] sfl, [88:166] sfs; spectra split into an exact int16 HEAD
# (per-channel lines 0..HEAD_LINES-1) and an int8 TAIL (the rest) — see
# consts.py
# meta layout (must match mp3parse.cpp parse_frame emit)
META_VARIANT = 0
META_FLAGS = 1  # bit0 ms, bit1 intensity, bit2 mono
META_COUNT1_R = 2
META_GLOBAL_GAIN = 4  # [2]
META_SF_SCALE = 6  # [2]
META_PREFLAG = 8  # [2]
META_BLOCK_TYPE = 10  # [2]
META_BLOCK_CLASS = 12  # [2]
META_SUBBLOCK_GAIN = 14  # [2][3]
META_COUNT1 = 20  # [2]
META_GR_INDEX = 22

_lib = None


def _host_cpu() -> str:
    """The CPU's model and feature flags (what -march=native compiles for)."""
    try:
        info = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor() or platform.machine()
    keys = ("model name", "flags", "Features", "CPU part")
    return "\n".join(sorted({ln for ln in info.splitlines() if ln.startswith(keys)}))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_host_cpu().encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libmp3parse.so"


def _build(out: Path) -> bool:
    """g++ into a temporary file, then an atomic rename; concurrent
    builders (test workers) take turns on a lock file, and whoever comes
    second finds the library built."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return True
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, *(str(_DIR / s) for s in _SOURCES), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        except (OSError, subprocess.TimeoutExpired):
            return False
        (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, out)
        return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
    lib.gmp_create.restype = ctypes.c_void_p
    lib.gmp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gmp_destroy.argtypes = [ctypes.c_void_p]
    lib.gmp_sample_rate.restype = ctypes.c_int
    lib.gmp_sample_rate.argtypes = [ctypes.c_void_p]
    lib.gmp_error.restype = ctypes.c_char_p
    lib.gmp_error.argtypes = [ctypes.c_void_p]
    lib.gmp_parse.restype = ctypes.c_int
    lib.gmp_parse.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gmp_parse_packed.restype = ctypes.c_int
    lib.gmp_parse_packed.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.gmp_parse_packed8.restype = ctypes.c_int
    lib.gmp_parse_packed8.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.gmp_packed8_overflow.restype = ctypes.c_int
    lib.gmp_packed8_overflow.argtypes = [ctypes.c_void_p]
    lib.gmp_pack_fused_tail_nch.restype = None
    lib.gmp_pack_fused_tail_nch.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.gmp_parse_packed8_many.restype = ctypes.c_int
    lib.gmp_parse_packed8_many.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gmp_create_stream.restype = ctypes.c_void_p
    lib.gmp_create_stream.argtypes = []
    lib.gmp_terminal.restype = ctypes.c_int
    lib.gmp_terminal.argtypes = [ctypes.c_void_p]
    lib.gmp_feed.argtypes = [
        ctypes.c_void_p,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.gmp_dsp_create.restype = ctypes.c_void_p
    lib.gmp_dsp_destroy.argtypes = [ctypes.c_void_p]
    lib.gmp_dsp_reset.argtypes = [ctypes.c_void_p]
    lib.gmp_dsp_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int16),
    ]
    lib.gmp_worker_create.restype = ctypes.c_void_p
    lib.gmp_worker_create.argtypes = []
    lib.gmp_worker_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.gmp_worker_join.restype = ctypes.c_int
    lib.gmp_worker_join.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.gmp_worker_start_many.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
    lib.gmp_worker_join_many.restype = ctypes.c_int
    lib.gmp_worker_join_many.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int32),
                                         ctypes.POINTER(ctypes.c_int32)]
    lib.gmp_worker_destroy.argtypes = [ctypes.c_void_p]
    lib.gmp_pos.restype = ctypes.c_int64
    lib.gmp_pos.argtypes = [ctypes.c_void_p]
    lib.gmp_get_reservoir.restype = ctypes.c_int
    lib.gmp_get_reservoir.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.gmp_set_reservoir.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.gmp_dsp_get_state.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gmp_dsp_set_state.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.gmp_index.restype = ctypes.c_int64
    lib.gmp_index.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _check_array(name: str, a, shape, dtype) -> None:
    """Raise unless `a` is a C-contiguous numpy array of `dtype` and
    `shape` (None: any size on that axis). Explicit raises, not asserts:
    these checks guard raw C pointer calls and must survive `python -O`."""
    if not isinstance(a, np.ndarray):
        raise TypeError(f"{name}: expected a numpy array, got {type(a).__name__}")
    if a.dtype != dtype:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {np.dtype(dtype)}")
    if a.ndim != len(shape) or any(
        want is not None and got != want for got, want in zip(a.shape, shape)
    ):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name}: not C-contiguous")


def _full_rows(spectra, sfl, sfs, meta) -> int:
    """The rows of parse_into's arrays, checked."""
    _check_array("spectra", spectra, (None, 2, 576), np.int16)
    cap = spectra.shape[0]
    _check_array("sfl", sfl, (cap, 2, 22), np.int32)
    _check_array("sfs", sfs, (cap, 2, 39), np.int32)
    _check_array("meta", meta, (cap, META_WIDTH), np.int32)
    return cap


def _packed_rows(spectra, side) -> int:
    """The rows of parse_packed_into's arrays, checked."""
    _check_array("spectra", spectra, (None, 1152), np.int16)
    cap = spectra.shape[0]
    _check_array("side", side, (cap, SIDE_WIDTH), np.int16)
    return cap


_forks = 0  # forks between the process that loaded this module and this one


def _forked() -> None:
    global _forks
    _forks += 1


os.register_at_fork(after_in_child=_forked)


class NativeParser:
    """Streaming granule parser over an in-memory MP3 byte buffer.

    `offset` starts parsing at a byte position without copying the buffer
    (used by Decoder.seek to restart at a frame boundary)."""

    def __init__(self, data: bytes, offset: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("libmp3parse.so not available")
        self._lib = lib
        self._data = data  # keep alive
        offset = int(offset)
        self.base_offset = offset
        base = ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p).value
        ptr = ctypes.c_char_p(base + offset)
        self._p = lib.gmp_create(ptr, len(data) - offset)

    def tell(self) -> int:
        """Current byte position within the original buffer."""
        return self.base_offset + int(self._lib.gmp_pos(self._p))

    def get_reservoir(self) -> bytes:
        buf = (ctypes.c_uint8 * 2048)()
        n = self._lib.gmp_get_reservoir(self._p, buf, 2048)
        return ctypes.string_at(buf, n)

    def set_reservoir(self, data: bytes) -> None:
        buf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
            data or b"\x00"
        )
        self._lib.gmp_set_reservoir(self._p, buf, len(data))

    _flight = None  # (worker, _forks then): a ParseWorker's parse of it in flight

    def close(self) -> None:
        """Free the parser, first waiting for a ParseWorker's parse of it in
        flight. In a process forked while one was, that parse may have
        been cut anywhere: the parser is left unfreed."""
        if self._flight is not None:
            worker, forks = self._flight
            if forks == _forks:
                self._lib.gmp_worker_join(worker, ctypes.byref(ctypes.c_int64()))
            else:
                self._p = None
            self._flight = None
        if self._p:
            self._lib.gmp_destroy(self._p)
            self._p = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def sample_rate(self) -> int:
        return self._lib.gmp_sample_rate(self._p)

    def parse_into(
        self,
        spectra: np.ndarray,
        sfl: np.ndarray,
        sfs: np.ndarray,
        meta: np.ndarray,
    ) -> int:
        """Parse granules directly into caller-provided C-contiguous arrays
        (shapes [cap,2,576], [cap,2,22], [cap,2,39], [cap,24], int32).
        Returns the number of granules produced (0 = end of audio)."""
        cap = _full_rows(spectra, sfl, sfs, meta)
        n = self._lib.gmp_parse(
            self._p, cap, _i16p(spectra), _i32p(sfl), _i32p(sfs), _i32p(meta)
        )
        if n < 0:
            err = self._lib.gmp_error(self._p).decode()
            raise ValueError(f"mp3: native parse failed: {err}")
        return n

    def parse_packed_into(self, spectra: np.ndarray, side: np.ndarray) -> int:
        """Parse granules directly into the packed device-interface layout:
        spectra [cap, 1152] int16 (post-reorder) and side [cap, SIDE_WIDTH]
        int16 (all metadata + scalefactors). Two flat, C-contiguous arrays =
        the cheapest possible H2D transfer. Returns granules produced."""
        cap = _packed_rows(spectra, side)
        n = self._lib.gmp_parse_packed(self._p, cap, _i16p(spectra), _i16p(side))
        if n < 0:
            err = self._lib.gmp_error(self._p).decode()
            raise ValueError(f"mp3: native parse failed: {err}")
        return n

    def parse_packed8_into(
        self, tail8: np.ndarray, head16: np.ndarray, side8: np.ndarray
    ) -> int:
        """Parse granules into the int8-quantized layout (~56% the bytes of
        the int16 interface): tail8 [cap,SP8_TAIL_WIDTH] i8 (per-channel
        lines HEAD_LINES..575), head16 [cap,HEAD_WIDTH] i16 (exact lines
        0..HEAD_LINES-1 — big magnitudes live near DC, so the tail fits
        int8 on real streams), side8 [cap,SIDE8_WIDTH] u8.

        Raises OverflowError if any tail line clipped (never observed on
        real streams). The overflowed granules were already consumed with
        CLIPPED values and this parser's position has advanced past them,
        so recovery means re-parsing the stream from the start with
        parse_packed_into (decode_corpus_fast does exactly that); this
        parser should be discarded."""
        _check_array("tail8", tail8, (None, SP8_TAIL_WIDTH), np.int8)
        cap = tail8.shape[0]
        _check_array("head16", head16, (cap, HEAD_WIDTH), np.int16)
        _check_array("side8", side8, (cap, SIDE8_WIDTH), np.uint8)
        n = self._lib.gmp_parse_packed8(
            self._p,
            cap,
            tail8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _i16p(head16),
            side8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if n < 0:
            err = self._lib.gmp_error(self._p).decode()
            raise ValueError(f"mp3: native parse failed: {err}")
        if self._lib.gmp_packed8_overflow(self._p):
            raise OverflowError(
                "mp3: tail spectra clipped int8; use parse_packed_into"
            )
        return n

    def parse(self, cap: int):
        """Parse up to `cap` granules. Returns (n, spectra, sfl, sfs, meta)
        where n==0 signals end of audio. Raises on malformed streams."""
        spectra = np.empty((cap, 2, 576), dtype=np.int16)
        sfl = np.empty((cap, 2, 22), dtype=np.int32)
        sfs = np.empty((cap, 2, 39), dtype=np.int32)
        meta = np.empty((cap, META_WIDTH), dtype=np.int32)
        n = self._lib.gmp_parse(
            self._p, cap, _i16p(spectra), _i32p(sfl), _i32p(sfs), _i32p(meta)
        )
        if n < 0:
            err = self._lib.gmp_error(self._p).decode()
            raise ValueError(f"mp3: native parse failed: {err}")
        return n, spectra[:n], sfl[:n], sfs[:n], meta[:n]

    def parse_all(self, chunk: int = 4096):
        """Parse the whole stream; returns concatenated arrays."""
        parts = []
        while True:
            n, sp, sl, ss, me = self.parse(chunk)
            if n == 0:
                break
            parts.append((sp, sl, ss, me))
        if not parts:
            z = np.zeros
            return (
                z((0, 2, 576), np.int16),
                z((0, 2, 22), np.int32),
                z((0, 2, 39), np.int32),
                z((0, META_WIDTH), np.int32),
            )
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


class BatchParser:
    """Many-stream chunk parser: one C call per [S, T] chunk (the corpus
    pipeline's inner loop), with partial-chunk rows zero-padded in C.
    Wraps per-stream NativeParsers; close() releases them all."""

    def __init__(self, stream_bytes: list[bytes]):
        self.parsers: list[NativeParser] = []
        try:
            for d in stream_bytes:
                self.parsers.append(NativeParser(d))
        except Exception:
            # release already-created C handles before re-raising
            for p in self.parsers:
                p.close()
            raise
        self._lib = _load()
        self._handles = (ctypes.c_void_p * len(self.parsers))(
            *[p._p for p in self.parsers]
        )

    def parse_chunk_into(
        self,
        tail8: np.ndarray,
        head16: np.ndarray,
        side8: np.ndarray,
        valids: np.ndarray,
        lo: int = 0,
        hi: int | None = None,
    ) -> int:
        """Parse the next chunk of every stream into [S, cap, ...] arrays
        (shapes [S,cap,SP8_TAIL_WIDTH] i8 / [S,cap,HEAD_WIDTH] i16 /
        [S,cap,SIDE8_WIDTH] u8, valids [S] i32). Returns max granules
        across streams (0 = corpus exhausted). Raises like
        parse_packed8_into on hard error / int8 overflow.

        lo/hi restrict the call to the contiguous lane block [lo, hi):
        one C call per block, so a thread pool with disjoint blocks keeps
        the many-call batching (each worker touches only its own rows of
        the arrays and its own parsers — GIL-free, byte-identical to
        serial)."""
        _check_array("tail8", tail8, (None, None, SP8_TAIL_WIDTH), np.int8)
        s, cap = tail8.shape[0], tail8.shape[1]
        if hi is None:
            hi = s
        _check_array("head16", head16, (s, cap, HEAD_WIDTH), np.int16)
        _check_array("side8", side8, (s, cap, SIDE8_WIDTH), np.uint8)
        _check_array("valids", valids, (s,), np.int32)
        # this bound guards raw C pointer arithmetic over the handles array
        # and the output rows
        if not (0 <= lo <= hi <= s == len(self.parsers)):
            raise ValueError(
                f"lane block [{lo}, {hi}) out of range for "
                f"{len(self.parsers)} parsers / {s} rows"
            )
        if lo == hi:
            return 0
        err_stream = ctypes.c_int32(-1)
        n = self._lib.gmp_parse_packed8_many(
            ctypes.cast(
                ctypes.byref(
                    self._handles, lo * ctypes.sizeof(ctypes.c_void_p)
                ),
                ctypes.POINTER(ctypes.c_void_p),
            ),
            hi - lo,
            cap,
            tail8[lo:hi].ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _i16p(head16[lo:hi]),
            side8[lo:hi].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _i32p(valids[lo:hi]),
            ctypes.byref(err_stream),
        )
        if n < 0:
            raise self.fault(n, lo + err_stream.value)
        return n

    def fault(self, code: int, stream: int) -> Exception:
        """The error of a many-stream parse that stopped with `code` at
        `stream`: -1 a hard parse error (ValueError), -2 an int8 tail
        overflow (OverflowError)."""
        if code == -1:
            err = self._lib.gmp_error(self.parsers[stream]._p).decode()
            return ValueError(f"mp3: native parse failed (stream {stream}): {err}")
        return OverflowError(
            f"mp3: tail spectra clipped int8; use parse_packed_into (stream {stream})")

    def close(self) -> None:
        for p in self.parsers:
            p.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class StreamingNativeParser(NativeParser):
    """Chunked-feed variant for non-materializable sources (pipes, sockets,
    unbounded streams — source.go:99-122 semantics): feed() bytes as they
    arrive, parse in bounded memory (consumed bytes are compacted away).
    parse_* returning 0 means "need more data" until eof has been fed."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libmp3parse.so not available")
        self._lib = lib
        self._data = None
        self.base_offset = 0
        self._eof = False
        self._p = lib.gmp_create_stream()

    def feed(self, data: bytes, eof: bool = False) -> None:
        self._lib.gmp_feed(self._p, data, len(data), 1 if eof else 0)
        self._eof = self._eof or eof

    @property
    def eof(self) -> bool:
        # terminal = the sync-search cap was hit with a full window: the
        # stream is dead (reference semantics) and feeding more is pointless
        return self._eof or bool(self._lib.gmp_terminal(self._p))

    def tell(self) -> int:
        """Global byte position across all fed chunks."""
        return int(self._lib.gmp_pos(self._p))


class ParseWorker:
    """A native thread that runs one parse at a time off the caller's
    thread (prefetch.cpp): start() a NativeParser's parse into rows, as
    parse_into or parse_packed_into would run it, then join() its result;
    or start_many() up to k chunks of a BatchParser's streams, then
    join_many(). No Python runs on the thread, so it never takes the
    interpreter lock; the thread and the join spin up to 2 ms before they
    sleep. The object keeps the parsers and the rows of the parse in
    flight alive until its join, and a parser waits for it before it
    frees itself; deleted, the worker waits for that parse and ends its
    thread. Fork copies no thread: in a forked child the worker is
    foreign(), and it and the parse it had in flight are left as they
    are."""

    def __init__(self):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("libmp3parse.so not available")
        self._forks = _forks
        self._w = self._lib.gmp_worker_create()
        self._ns = ctypes.c_int64()
        self._job = None  # (parsers, what else it needs) of the parse in flight

    def foreign(self) -> bool:
        """True in a process forked from the one that made the worker: its
        thread did not follow."""
        return self._forks != _forks

    def _fly(self, parsers, keep) -> None:
        self._job = (parsers, keep)
        for p in parsers:
            p._flight = (self._w, self._forks)

    def _land(self):
        """The parse in flight's job, its parsers free again."""
        (parsers, keep), self._job = self._job, None
        for p in parsers:
            p._flight = None
        return parsers, keep

    def start(self, into, parser: NativeParser, *rows: np.ndarray) -> None:
        """Start into(parser, *rows) on the thread; `into` is
        NativeParser.parse_into or NativeParser.parse_packed_into."""
        if into is NativeParser.parse_packed_into:
            packed, cap = 1, _packed_rows(*rows)
        elif into is NativeParser.parse_into:
            packed, cap = 0, _full_rows(*rows)
        else:
            raise ValueError(f"ParseWorker: no native form of {into!r}")
        self._fly([parser], rows)
        ptrs = [a.ctypes.data for a in rows] + [None] * (4 - len(rows))
        self._lib.gmp_worker_start(self._w, parser._p, cap, packed, *ptrs)

    def join(self) -> tuple[int, float]:
        """(granules, seconds the parse took) of the parse started last: its
        return value, and its error raised here as it would have raised."""
        n = self._lib.gmp_worker_join(self._w, ctypes.byref(self._ns))
        (parser,), _ = self._land()
        if n < 0:
            err = self._lib.gmp_error(parser._p).decode()
            raise ValueError(f"mp3: native parse failed: {err}")
        return n, self._ns.value / 1e9

    def start_many(self, batch: BatchParser, tail8: np.ndarray, head16: np.ndarray,
                   side8: np.ndarray, valids: np.ndarray) -> None:
        """Start the parse of up to k chunks of every stream of `batch` on
        the thread, into [k, S, cap, ..] rows and valids [k, S] (zeroed
        here: a chunk past the stop keeps 0), chunk c as
        batch.parse_chunk_into(tail8[c], head16[c], side8[c], valids[c])
        would parse it, stopping at the first chunk with no granule or at
        an error."""
        _check_array("tail8", tail8, (None, None, None, SP8_TAIL_WIDTH), np.int8)
        k, s, cap = tail8.shape[:3]
        _check_array("head16", head16, (k, s, cap, HEAD_WIDTH), np.int16)
        _check_array("side8", side8, (k, s, cap, SIDE8_WIDTH), np.uint8)
        _check_array("valids", valids, (k, s), np.int32)
        if s != len(batch.parsers):  # guards the C loop over the handles
            raise ValueError(f"{s} rows for {len(batch.parsers)} parsers")
        valids[:] = 0
        self._fly(batch.parsers, (batch, tail8, head16, side8, valids))
        self._lib.gmp_worker_start_many(
            self._w, batch._handles, s, cap, k, tail8.ctypes.data, head16.ctypes.data,
            side8.ctypes.data, valids.ctypes.data, tail8.strides[0], head16.strides[0],
            side8.strides[0])

    def join_many(self) -> tuple[int, float, Exception | None]:
        """(chunks with a granule before the stop, seconds the parse took,
        the error that stopped it or None) of the parse start_many began
        last. The error is the one parse_chunk_into raises, handed back for
        the caller to raise once it has used the chunks before it."""
        status, stream = ctypes.c_int32(), ctypes.c_int32()
        n = self._lib.gmp_worker_join_many(self._w, ctypes.byref(self._ns),
                                           ctypes.byref(status), ctypes.byref(stream))
        _, (batch, *_) = self._land()
        err = batch.fault(status.value, stream.value) if status.value else None
        return n, self._ns.value / 1e9, err

    def __del__(self):
        if getattr(self, "_w", None) and self._forks == _forks:
            self._lib.gmp_worker_destroy(self._w)  # waits for a parse in flight
            if self._job is not None:
                self._land()


class NativeDsp:
    """Exact-arithmetic C++ granule DSP (bit-exact mode / CPU fallback).

    Replicates the reference's float32 operation order; see mp3dsp.cpp."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("libmp3parse.so not available")
        self._lib = lib
        self._s = lib.gmp_dsp_create()

    def close(self) -> None:
        if self._s:
            self._lib.gmp_dsp_destroy(self._s)
            self._s = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self) -> None:
        self._lib.gmp_dsp_reset(self._s)

    def get_state(self) -> tuple[np.ndarray, np.ndarray]:
        """(store [2,32,18] f32, v_vec [2,1024] f32) for checkpointing."""
        store = np.empty((2, 32, 18), np.float32)
        vvec = np.empty((2, 1024), np.float32)
        self._lib.gmp_dsp_get_state(
            self._s,
            store.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            vvec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return store, vvec

    def set_state(self, store: np.ndarray, v_vec: np.ndarray) -> None:
        store = np.ascontiguousarray(store, np.float32)
        v_vec = np.ascontiguousarray(v_vec, np.float32)
        _check_array("store", store, (2, 32, 18), np.float32)
        _check_array("v_vec", v_vec, (2, 1024), np.float32)
        self._lib.gmp_dsp_set_state(
            self._s,
            store.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            v_vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )

    def decode(
        self,
        spectra: np.ndarray,
        sfl: np.ndarray,
        sfs: np.ndarray,
        meta: np.ndarray,
    ) -> np.ndarray:
        """Decode n granule records -> int16 PCM [n*576, 2]."""
        _check_array("spectra", spectra, (None, 2, 576), np.int16)
        n = spectra.shape[0]
        _check_array("sfl", sfl, (n, 2, 22), np.int32)
        _check_array("sfs", sfs, (n, 2, 39), np.int32)
        _check_array("meta", meta, (n, META_WIDTH), np.int32)
        pcm = np.empty((n * 576, 2), dtype=np.int16)
        self._lib.gmp_dsp_decode(
            self._s,
            n,
            _i16p(spectra),
            _i32p(sfl),
            _i32p(sfs),
            _i32p(meta),
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        )
        return pcm


def pack_fused_tail(
    spectra: np.ndarray, buf: np.ndarray, l: int, nch: int = 2
) -> bool:
    """Native [S,T,1024] -> [S,nch,l,T] tail transpose for
    build_fused_chunk (16x16 cache-blocked; numpy's strided assignment
    runs ~1.5 GB/s on this layout). `buf` is the whole fused
    [S, stream_bytes] uint8 buffer; the tail region is its per-row prefix
    (nch*l*T bytes). nch=1 packs only channel 0 (mono-lane wire layout).
    Returns False when the library is unavailable so the caller falls
    back to numpy."""
    lib = _load()
    if lib is None:
        return False
    # real checks, not asserts: the C kernel hard-codes the [.., 1024]
    # granule-row strides and the 512-line channel split, so any layout
    # deviation must fall back to the numpy path (which raises loudly on
    # shape mismatches) instead of reaching C with wrong strides
    if not (
        spectra.ndim == 3
        and spectra.shape[2] == SP8_TAIL_WIDTH
        and spectra.dtype == np.int8
        and spectra.flags.c_contiguous
        and 0 < l <= SP8_TAIL_WIDTH // 2
        and nch in (1, 2)
        and buf.dtype == np.uint8
        and buf.ndim == 2
        and buf.shape[0] == spectra.shape[0]
        and buf.strides[1] == 1
        and buf.shape[1] >= nch * l * spectra.shape[1]
    ):
        return False
    s, t = spectra.shape[0], spectra.shape[1]
    lib.gmp_pack_fused_tail_nch(
        spectra.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        s,
        t,
        l,
        buf.strides[0],
        nch,
    )
    return True


def index_stream(data: bytes):
    """Header-only index scan: (frame_starts int64[], bytes_per_frame,
    sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmp3parse.so not available")
    cap = max(len(data) // 24, 64)  # frames are >= 24 bytes
    starts = np.empty(cap, dtype=np.int64)
    bpf = ctypes.c_int32(0)
    sr = ctypes.c_int32(0)
    n = lib.gmp_index(
        data,
        len(data),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cap,
        ctypes.byref(bpf),
        ctypes.byref(sr),
    )
    return starts[:n].copy(), int(bpf.value), int(sr.value)
