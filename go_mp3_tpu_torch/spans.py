"""Spans and counters of go_mp3_tpu_torch, on the profiler's clock.

The port's one place for tracing its own work. Spans and counters are off
unless a torch.profiler runs: off, span() hands back one shared object
that does nothing, and count() returns at once, so the cost is one check
of the profiler's state and an empty `with` (about half a microsecond a
span on an H100 machine's host). To turn them on, run the code under a
profiler, as for a trace of the card:

    from torch.profiler import ProfilerActivity, profile
    from go_mp3_tpu_torch import decode_corpus_fast, spans

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_corpus_fast(streams)
    spans.totals()

On, each span is a record_function event of the trace, beside the kernels
and copies it launched (prof.export_chrome_trace), and adds to module
totals: totals() -> {"spans": {name: {"n", "s", "self_s"}}, "counts":
{name: n}}, where s is the span's time on the host clock and self_s that
time less the time of the spans nested in it on the same thread. reset()
clears the totals. Spans opened in other threads of the process count in
the totals while the profiler runs; the trace holds them where the
profiler records that thread.

Spans (a root holds the rest of its group; what no inner span covers is
the root's own time):
 - gomp3.corpus.call: a decode_corpus_fast call, reruns included;
   gomp3.corpus.parse, .pack, .emit: the host phases of phase_seconds,
   timed by the same clock readings; gomp3.corpus.wait: the host blocked
   on the card (an event's or a stream's synchronize);
 - gomp3.decoder.open, .seek, .read: Decoder(...), Decoder.seek (and the
   seeks through seek_to_time, seek_to_sample and skip), Decoder.read;
   inside them, on the native path, gomp3.decoder.parse (a C++ parse
   into the stream's rows: a seek's warm-up frames, or a decode's
   granules; a prefetch's parse runs on a native worker thread, outside
   every root, and adds to the totals through record() when the caller
   joins it, with no trace event), .prefetch_wait (the caller blocked
   joining that worker: the part of the prefetch's parse that the overlap
   did not hide), and in a device decode .h2d (the rows' copies to the
   card, enqueued), .launch (the chain's launch), .d2h (the PCM's copy
   back, enqueued, and the one wait for it and the chain).
Counters:
 - gomp3.corpus.reruns: whole decode_corpus_fast runs made again (a lane
   classed mono met a stereo granule; int8 tails overflowed to int16);
   of the run whose result a call returns: gomp3.corpus.granules, the
   valid granules; gomp3.corpus.mono_granules, those shipped on the
   half-width mono wire; gomp3.corpus.wire_bytes, the bytes shipped to
   the devices (CorpusResult.wire_bytes); gomp3.corpus.slots, the
   lane-granule slots shipped to the chain, valid or not (chunks x lanes
   x chunk_t: a lane that has ended, or ends inside a chunk, still ships
   its rows);
 - gomp3.decoder.warmup_frames: frames decoded and dropped before a
   seek's target. A native stream decodes on one path: each decode
   parses into the stream's rows and runs the DSP once on them, up to
   128 granules (the readahead), or after a seek the warm-up frames it
   parsed and whole frames after them until they cover the read.
   gomp3.decoder.granules: granules a device decode returned;
   gomp3.decoder.rows: rows it copied to the card, its granules rounded
   up to 4 (K5's longest run); gomp3.decoder.seek_folds: decodes that
   carried a seek's warm-up frames with the granules of the read after
   it; gomp3.decoder.pinned_calls: device decodes whose copies went
   through the stream's pinned staging (every one on CUDA, none on the
   CPU); gomp3.decoder.prefetched: decodes whose granules a prefetch
   parsed (every readahead but the first after an open or a seek's fold,
   on a seekable source).
"""

from __future__ import annotations

import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _Record
except ImportError:  # an older torch
    from torch.profiler import record_function as _Record

__all__ = ["count", "enabled", "record", "reset", "span", "timed", "totals"]

_profiler_enabled = torch._C._autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_spans: dict[str, list] = {}  # name -> [n, s, self_s]
_counts: dict[str, int] = {}


def enabled() -> bool:
    """Whether a torch.profiler runs: on this thread (the profiler's own
    state), or on another thread of the process (torch's flag)."""
    return _profiler_enabled() or _autograd_profiler._is_profiler_enabled


class _Off:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span timed on the host clock; recorded (trace event and totals)
    where the profiler ran when it was entered. `seconds` holds its time
    once it has closed."""

    __slots__ = ("name", "seconds", "_t0", "_child", "_record")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._record = None

    def __enter__(self):
        if enabled():
            self._record = _Record(self.name)
            self._record.__enter__()
            self._child = 0.0
            _stack().append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = dt = time.perf_counter() - self._t0
        record = self._record
        if record is not None:
            self._record = None
            stack = _stack()
            stack.pop()
            if stack:
                stack[-1]._child += dt
            with _lock:
                row = _spans.setdefault(self.name, [0, 0.0, 0.0])
                row[0] += 1
                row[1] += dt
                row[2] += dt - self._child
            record.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span `name` while a profiler runs, else a
    shared object that does nothing."""
    if _profiler_enabled() or _autograd_profiler._is_profiler_enabled:  # enabled(), inlined
        return _Span(name)
    return _OFF


def timed(name: str) -> _Span:
    """As span(), but always timed on the host clock (`.seconds` after it
    closed), for a caller that needs the time with or without a profiler."""
    return _Span(name)


def record(name: str, seconds: float) -> None:
    """Add one span of `seconds`, timed on a thread that runs no Python (a
    native worker's), to the totals while a profiler runs: all of its time
    its own, no part of a span open here, and no event of the trace."""
    if _profiler_enabled() or _autograd_profiler._is_profiler_enabled:
        with _lock:
            row = _spans.setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += seconds
            row[2] += seconds


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a profiler runs."""
    if _profiler_enabled() or _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def totals() -> dict:
    """{"spans": {name: {"n", "s", "self_s"}}, "counts": {name: n}} since
    the last reset()."""
    with _lock:
        return {"spans": {k: {"n": n, "s": s, "self_s": own}
                          for k, (n, s, own) in _spans.items()},
                "counts": dict(_counts)}


def reset() -> None:
    """Clear the totals."""
    with _lock:
        _spans.clear()
        _counts.clear()
