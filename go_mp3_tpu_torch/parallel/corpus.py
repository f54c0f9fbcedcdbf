"""Multi-stream corpus decoding, on one device or split over a mesh.

decode_corpus_fast, the throughput entry point, is the counterpart of
go_mp3_tpu/parallel/corpus.py's, with the JAX function's parameters in
its order and with its defaults, then a keyword-only `device`.
decode_corpus, its "auditability path", decodes streams pre-parsed by the
pure-Python parser (parse_stream_granules), as GranuleBatches through the
chain kernel's GranuleBatch route, one chunk at a time.

In decode_corpus_fast the C++ parser fills [S, T] chunks of every stream
into host arrays, the next chunk or segment on a worker thread while the
caller packs and ships the current one; the chunks reach the card
in pinned, double-buffered host buffers and are decoded with the
per-stream state carried on the card, on one CUDA stream.

fused=True (the default) is the production path:
 - lanes whose first frame is mono ship the half-width mono wire
   (mono_split), stereo lanes the stereo wire (ops/wire.py); each lane
   group decodes on its own, and results come back in the caller's order;
 - tail_buckets caps each group's shipped tail lines at the smallest
   bucket covering the nonzero lines (exact: the extent is scanned);
 - on the card the chain kernel (K1 -> K2 -> K3 in one launch) reads the
   wire rows themselves and decodes them, chunk by chunk
   (parallel/segment.py run_segment_eager), or with drain=k as one
   captured CUDA graph per k-chunk segment (SegmentGraph);
 - the next chunk's (segment's) parse runs ahead, into a second pool of
   parser rows, on a native worker thread of the call's own, or with
   n_threads > 1 on disjoint lane blocks in a pool of worker threads.
fused=False is the three-array int8 interface; both paths drop to the int16
interface when a stream's tail spectra overflow int8 (an input-range path,
on the same device).

mesh (parallel/mesh.py): shard, then split. Mesh entry d owns the
caller's contiguous lane block d and runs the one-device pipeline above on
its own device (its own lane groups, widths, states and SegmentGraphs);
the host parse is shared, and each entry's rows go from the pinned host
buffers straight to its device. No lane crosses a device.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import spans
from ..bitstream import Source, read_header
from ..bitstream.frameheader import Mode
from ..bitstream.parser import FrameReader
from ..consts import (
    HEAD_WIDTH,
    SAMPLES_PER_GR,
    SIDE8_WIDTH,
    SIDE_WIDTH,
    SP8_TAIL_WIDTH,
    EOFError_,
    SyncSearchLimitError,
    UnexpectedEOFError,
)
from ..device import resolve_device
from ..models.pipeline import GranuleMeta, granules_from_frame, pack_granule_batch
from ..native.lib import BatchParser, NativeParser, ParseWorker
from ..ops.granule import GranuleBatch, batch_to, init_state
from ..ops.kernels import decode_chunk
from ..ops.wire import (
    TAIL_LINES_FULL,
    build_fused_chunk,
    build_fused_chunk_mono,
    bucket_tail_lines,
    chunk_all_mono,
    stream_nbytes,
    tail_cap_lines,
    tail_need_lines,
)
from .mesh import Mesh
from .segment import SegmentGraph, run_segment_eager, static_slots

# public here as in go_mp3_tpu.parallel.corpus
__all__ = [
    "CorpusResult",
    "DeviceCorpus",
    "build_fused_chunk",
    "build_fused_chunk_mono",
    "bucket_tail_lines",
    "chunk_all_mono",
    "decode_corpus",
    "decode_corpus_fast",
    "parse_stream_granules",
    "tail_cap_lines",
    "tail_need_lines",
]

_PHASES = ("parse", "pack", "h2d", "kernels", "d2h", "emit")


def parse_stream_granules(data: bytes, limit: int | None = None) -> list[GranuleMeta]:
    """Parse a whole MP3 byte stream into granule records with the
    pure-Python parser (at least `limit` granules, where given, or all)."""
    src = Source(io.BytesIO(data))
    src.skip_tags()
    fr = FrameReader()
    out: list[GranuleMeta] = []
    while limit is None or len(out) < limit:
        try:
            f = fr.read(src, src.pos)
        except (EOFError_, UnexpectedEOFError, SyncSearchLimitError):
            break
        out.extend(granules_from_frame(f))
    return out


@dataclass
class CorpusResult:
    pcm: list[bytes]  # per-stream s16le stereo PCM
    granules: int  # total granules decoded
    samples: int  # total output samples (per channel)
    # seconds by phase: "parse", "pack" (fused wire rows built from the
    # parsed arrays, tail extents scanned) and "emit" (PCM rows copied out
    # of the pinned buffers and joined per stream) on the host clock;
    # "h2d", "kernels", "d2h" as CUDA event time on each device's stream
    # (host clock on the CPU), summed over the mesh entries
    phase_seconds: dict = field(default_factory=dict)
    # each chunk's shipped tail width per lane group (fused path; per mesh
    # entry, its stereo group first), the input bytes copied to the
    # devices, and this run's SegmentGraph replays and captures (host
    # seconds, warm-up included)
    chunk_widths: list = field(default_factory=list)
    wire_bytes: int = 0
    graph_replays: int = 0
    graph_capture_seconds: float = 0.0


class DeviceCorpus(tuple):
    """fetch=False's result: (pcm, valids), which unpacks like
    go_mp3_tpu's; `stats` is the run's CorpusResult without PCM (phase
    split, widths, wire bytes)."""

    def __new__(cls, pcm, valids: np.ndarray, stats: CorpusResult):
        self = super().__new__(cls, (pcm, valids))
        self.stats = stats
        return self


class _Timer:
    """Per-phase time: CUDA events on the named device's current stream for
    device phases (read once, at the end, so timing adds no
    synchronisation), the host clock otherwise; a host phase run through
    span() is also the span gomp3.corpus.<phase> (go_mp3_tpu_torch.spans)."""

    def __init__(self):
        self.host = dict.fromkeys(_PHASES, 0.0)
        self.events: list[tuple[str, object, object]] = []

    def mark(self, device: torch.device):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, phase: str):
        """A host phase: one host-clock reading, into its seconds and,
        while a profiler runs, its span."""
        with spans.timed("gomp3.corpus." + phase) as s:
            yield
        self.host[phase] += s.seconds

    def add(self, phase: str, start, end) -> None:
        if isinstance(start, torch.cuda.Event):
            self.events.append((phase, start, end))
        else:
            self.host[phase] += end - start

    def seconds(self) -> dict:
        out = dict(self.host)
        for phase, a, b in self.events:
            out[phase] += a.elapsed_time(b) / 1e3
        return out


def _count_returned(granules: int, mono_granules: int, wire_bytes: int,
                    slots: int) -> None:
    """The counters of the attempt whose result a decode_corpus_fast call
    returns (go_mp3_tpu_torch.spans; nothing unless a profiler runs)."""
    spans.count("gomp3.corpus.granules", granules)
    spans.count("gomp3.corpus.slots", slots)
    spans.count("gomp3.corpus.mono_granules", mono_granules)
    spans.count("gomp3.corpus.wire_bytes", wire_bytes)


def _check_mesh_device(mesh: Mesh, device) -> None:
    if device is not None and not mesh.holds(device):
        raise ValueError(f"device {device} is not in the mesh {mesh.devices}")


def _synchronize(devices) -> None:
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def decode_corpus(
    streams: list[list[GranuleMeta]],
    chunk_t: int = 128,
    decode_fn=None,
    device=None,
) -> CorpusResult:
    """Decode pre-parsed streams in lockstep [S, chunk_t] chunks.

    Each chunk is staged on the host as one GranuleBatch (a stream that
    has ended contributes zero rows and valid 0, which keeps its state),
    copied to `device` and decoded by decode_fn(batch, states, valid) ->
    (pcm int16 [S, chunk_t*576, 2], states), by default
    kernels.decode_chunk: the chain kernel on its GranuleBatch route.
    phase_seconds has "pack" and "emit" on the host clock and "h2d",
    "kernels", "d2h" as CUDA event time ("parse" is the caller's).

    decode_fn=mesh.make_sharded_decoder(mesh) splits the streams over the
    mesh: each chunk stays on the host and each mesh entry copies its own
    lane block, so "kernels" (host clock, up to the entries' last kernel:
    every entry is synchronised) includes those copies and "h2d" is 0;
    `device` may then only name an entry of the mesh.

    device: None means CUDA (raises where CUDA is unavailable); "cpu" runs
    the plain PyTorch chain."""
    mesh = getattr(decode_fn, "mesh", None)
    if mesh is not None:
        _check_mesh_device(mesh, device)
        device = torch.device("cpu")
    else:
        device = resolve_device(device)
    if decode_fn is None:
        decode_fn = decode_chunk
    n_streams = len(streams)
    timer = _Timer()
    states = init_state(n_streams, device)
    parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    max_len = max((len(s) for s in streams), default=0)
    total = sum(len(s) for s in streams)

    for start in range(0, max_len, chunk_t):
        with timer.span("pack"):
            packed = [pack_granule_batch(s[start : start + chunk_t], pad_to=chunk_t)
                      for s in streams]
            stacked = GranuleBatch(*(torch.cat(f) for f in zip(*(b for b, _ in packed))))
            valids = [v for _, v in packed]
        e0 = timer.mark(device)
        batch = batch_to(stacked, device)
        valid = torch.tensor(valids, dtype=torch.int32, device=device)
        e1 = timer.mark(device)
        pcm, states = decode_fn(batch, states, valid)
        if mesh is not None:  # the entries' work is queued on their own streams
            _synchronize(mesh.devices)
        e2 = timer.mark(device)
        host = pcm.cpu().numpy()
        e3 = timer.mark(device)
        timer.add("h2d", e0, e1)
        timer.add("kernels", e1, e2)
        timer.add("d2h", e2, e3)
        with timer.span("emit"):
            for i, v in enumerate(valids):
                if v:
                    parts[i].append(host[i, : v * SAMPLES_PER_GR].tobytes())

    return CorpusResult(
        pcm=[b"".join(p) for p in parts],
        granules=total,
        samples=total * SAMPLES_PER_GR,
        phase_seconds=timer.seconds(),
    )


class _MonoSplitMismatch(Exception):
    """A lane classed mono by its first frame produced a stereo granule:
    the mono wire cannot carry it, so the corpus reruns unsplit."""


def decode_corpus_fast(
    stream_bytes: list[bytes],
    chunk_t: int = 256,
    fetch: bool = True,
    mesh: Mesh | None = None,
    drain: int | None = None,
    fused: bool = True,
    tail_buckets: tuple[int, ...] | None = None,
    n_threads: int = 1,
    mono_split: bool = True,
    *,
    device=None,
):
    """Decode independent MP3 streams in lockstep [S, chunk_t] chunks.

    Returns a CorpusResult; with fetch=False, (pcm int16 [C, S,
    chunk_t*576, 2] on the device, valids int32 [C, S] numpy), both in the
    caller's lane order, as go_mp3_tpu's decode_corpus_fast returns them,
    once the card has finished (a DeviceCorpus, whose .stats has the
    run's phase split). fetch=False holds the whole corpus's PCM on the card, twice over for a
    moment at the end (per-chunk rows, then their stack).

    Lanes may mix MPEG versions and sample rates (MPEG-1 at 32, 44.1 and
    48 kHz, MPEG-2 LSF at 16, 22.05 and 24 kHz), and so end in different
    chunks: each granule carries its own band tables. Every chunk ships
    chunk_t rows of every lane, so a lane that has ended still ships its
    rows (valid 0, its state kept) until the longest lane ends; the
    counter gomp3.corpus.slots (go_mp3_tpu_torch.spans) counts those
    slots, valid or not, beside gomp3.corpus.granules, the valid ones.

    mesh (parallel/mesh.make_mesh): split the streams over the mesh's
    devices; len(stream_bytes) must divide by mesh.size (ValueError
    otherwise), and `device`, if given, must be an entry of the mesh.
    Entry d decodes the caller's contiguous lane block d on its device with
    the whole pipeline below, so the mono split never has to fall back
    when a lane group does not divide the mesh, as JAX's does
    (go_mp3_tpu/parallel/corpus.py:515-517), and no lane is reordered
    across devices; chunk_widths then lists each entry's groups, and can
    differ from JAX's, but the PCM cannot. With fetch=False, pcm is a
    tuple of one int16 [C, S/n, chunk_t*576, 2] tensor per mesh entry, on
    its device, the caller's lanes in order: concatenating them along
    axis 1 on the host gives JAX's array. phase_seconds adds the entries'
    card time per phase.

    drain=k (fused, fetch=True): decode in segments of k chunks, each a
    replay of one captured CUDA graph (an eager loop on the CPU); host and
    device memory stay O(k). fetch=False ignores it, as the JAX function
    does. tail_buckets: ascending per-channel tail widths to cap the wire
    at (per chunk, or per segment with drain). n_threads: parser worker
    threads on disjoint lane blocks (fused path). mono_split: the mono
    wire for lanes whose first frame is mono (fused path).

    The fused path parses the next chunk (segment, with drain) ahead on a
    worker, whatever n_threads: a native thread of the call's own at
    n_threads=1, the n_threads pool otherwise, into a second pool of
    parser rows, while the caller packs, ships and emits the current one.
    phase_seconds["parse"] (and the span gomp3.corpus.parse) is the
    parse's own time on the worker; the caller's wait for it is the span
    gomp3.corpus.parse_wait. A parse's error raises as the serial parse
    raised it.

    device: None means CUDA (raises where CUDA is unavailable); "cpu" runs
    the plain PyTorch chain."""
    sharded = mesh is not None
    if sharded:
        _check_mesh_device(mesh, device)
        mesh.blocks(len(stream_bytes))
    else:  # one device: a mesh of one entry
        mesh = Mesh((resolve_device(device),))
    if drain is not None and drain < 1:
        raise ValueError(f"drain must be >= 1, got {drain}")
    if not stream_bytes:
        return CorpusResult(pcm=[], granules=0, samples=0)
    with spans.span("gomp3.corpus.call"):
        if fused:
            try:
                opts = (chunk_t, fetch, drain, tail_buckets, n_threads, mesh, sharded)
                try:
                    return _decode_fused(stream_bytes, *opts, split=mono_split)
                except _MonoSplitMismatch:
                    spans.count("gomp3.corpus.reruns")
                    return _decode_fused(stream_bytes, *opts, split=False)
            except OverflowError:
                spans.count("gomp3.corpus.reruns")
                return _decode(stream_bytes, chunk_t, mesh, sharded, fetch, int8=False)
        try:
            return _decode(stream_bytes, chunk_t, mesh, sharded, fetch, int8=True)
        except OverflowError:
            spans.count("gomp3.corpus.reruns")
            return _decode(stream_bytes, chunk_t, mesh, sharded, fetch, int8=False)


def _device_result(kept, sharded: bool):
    """fetch=False's PCM: per mesh entry, its chunk rows stacked."""
    stacked = tuple(torch.stack(rows) for rows in kept)
    return stacked if sharded else stacked[0]


class _Int8Chunks:
    """The int8 interface: one C call parses a chunk of every stream."""

    def __init__(self, streams: list[bytes]):
        self.batch = BatchParser(streams)
        self.widths = (
            (SP8_TAIL_WIDTH, torch.int8),
            (HEAD_WIDTH, torch.int16),
            (SIDE8_WIDTH, torch.uint8),
        )

    def parse(self, arrays, valids) -> None:
        self.batch.parse_chunk_into(*arrays, valids)

    def close(self) -> None:
        self.batch.close()


class _Int16Chunks:
    """The int16 interface (go_mp3_tpu/parallel/corpus.py:328-371)."""

    def __init__(self, streams: list[bytes]):
        self.parsers = []
        try:
            for d in streams:
                self.parsers.append(NativeParser(d))
        except Exception:
            self.close()
            raise
        self.widths = ((1152, torch.int16), (SIDE_WIDTH, torch.int16))

    def parse(self, arrays, valids) -> None:
        spectra, side = arrays
        for s, p in enumerate(self.parsers):
            n = p.parse_packed_into(spectra[s], side[s])
            valids[s] = n
            spectra[s, n:] = 0
            side[s, n:] = 0

    def close(self) -> None:
        for p in self.parsers:
            p.close()


def _decode(streams, chunk_t, mesh: Mesh, sharded: bool, fetch: bool, int8: bool):
    """The three-array interfaces, one chunk at a time."""
    n_streams = len(streams)
    blocks = mesh.blocks(n_streams)
    pinned = any(d.type == "cuda" for d in mesh.devices)
    timer = _Timer()
    source = (_Int8Chunks if int8 else _Int16Chunks)(streams)

    def host_buffers():
        arrays = tuple(
            torch.empty((n_streams, chunk_t, w), dtype=dt, pin_memory=pinned)
            for w, dt in source.widths
        )
        valid = torch.empty(n_streams, dtype=torch.int32, pin_memory=pinned)
        pcm = torch.empty(
            (n_streams, chunk_t * SAMPLES_PER_GR, 2), dtype=torch.int16,
            pin_memory=pinned,
        )
        return {"in": arrays, "valid": valid, "pcm": pcm, "copied": []}

    # two sets, so the host parses chunk c+1 while chunk c's copies run;
    # a set is refilled only after every entry's H2D copies of it completed
    # ("copied")
    bufs = (host_buffers(), host_buffers())
    parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    kept = [[] for _ in blocks]  # fetch=False: PCM rows per mesh entry
    valid_rows = []
    states = [init_state(hi - lo, dev) for dev, lo, hi in blocks]
    total = wire_bytes = slots = 0
    pending = None  # (pcm host buffer, valids, events marking its D2H done)

    def emit(pcm_host, valids, done) -> None:
        with spans.span("gomp3.corpus.wait"):
            for ev in done:
                ev.synchronize()
        with timer.span("emit"):
            host = pcm_host.numpy()
            for s in range(n_streams):
                v = int(valids[s])
                if v:
                    parts[s].append(host[s, : v * SAMPLES_PER_GR].tobytes())

    try:
        for c in itertools.count():
            buf = bufs[c % 2]
            with spans.span("gomp3.corpus.wait"):
                for ev in buf["copied"]:
                    ev.synchronize()
            with timer.span("parse"):
                valids = buf["valid"].numpy()
                valids[:] = 0
                source.parse(tuple(a.numpy() for a in buf["in"]), valids)
            if not valids.any():
                break
            total += int(valids.sum())
            slots += n_streams * chunk_t

            wire_bytes += sum(a.numel() * a.element_size() for a in buf["in"])
            buf["copied"], done = [], []
            for i, (dev, lo, hi) in enumerate(blocks):
                e0 = timer.mark(dev)
                dev_in = tuple(a[lo:hi].to(dev, non_blocking=True) for a in buf["in"])
                valid_dev = buf["valid"][lo:hi].to(dev, non_blocking=True)
                e1 = timer.mark(dev)
                pcm_dev, states[i] = decode_chunk(dev_in, states[i], valid_dev)
                e2 = timer.mark(dev)
                timer.add("h2d", e0, e1)
                timer.add("kernels", e1, e2)
                if dev.type == "cuda":
                    buf["copied"].append(e1)
                if not fetch:
                    kept[i].append(pcm_dev)
                    continue
                buf["pcm"][lo:hi].copy_(pcm_dev, non_blocking=True)
                e3 = timer.mark(dev)
                timer.add("d2h", e2, e3)
                if dev.type == "cuda":
                    done.append(e3)
            if not fetch:
                valid_rows.append(valids.copy())
                continue
            if pending is not None:
                emit(*pending)
            pending = (buf["pcm"], valids.copy(), done)
        if pending is not None:
            emit(*pending)
    finally:
        source.close()
    if valid_rows:
        pcm_dev = _device_result(kept, sharded)
    with spans.span("gomp3.corpus.wait"):
        _synchronize(mesh.devices)
    with timer.span("emit"):
        pcm = [b"".join(p) for p in parts]
    _count_returned(total, 0, wire_bytes, slots)
    res = CorpusResult(
        pcm=pcm,
        granules=total,
        samples=total * SAMPLES_PER_GR,
        phase_seconds=timer.seconds(),
        wire_bytes=wire_bytes,
    )
    if fetch or not valid_rows:
        return res
    return DeviceCorpus(pcm_dev, np.stack(valid_rows), res)


# -- the fused path ----------------------------------------------------------


class _Group(NamedTuple):
    """Lanes [lo, hi) of the internal order, decoded by mesh entry `shard`;
    mono: the mono wire."""

    lo: int
    hi: int
    mono: bool
    shard: int


def _mono_first_frame(data: bytes) -> bool:
    """go_mp3_tpu/parallel/corpus.py:382-394: is the first frame mono?"""
    try:
        src = Source(io.BytesIO(data))
        src.skip_tags()
        h, _ = read_header(src, src.pos)
        return h.mode == Mode.SINGLE_CHANNEL
    except Exception:
        return False  # unclassifiable: the stereo wire carries anything


class _Rows(NamedTuple):
    """One pool of parser rows for a segment of k chunks: tail int8 [k, S,
    T, ..], head int16, side uint8, valids int32 [k, S] (lane order
    internal)."""

    tail: np.ndarray
    head: np.ndarray
    side: np.ndarray
    valids: np.ndarray


class _SegmentParser:
    """Parses up to k chunks of every lane into a pool of rows, the next
    segment ahead of the caller: start() begins its parse into the pool
    the caller does not hold, join() waits for it and hands that pool
    over; a pool is parsed into again only at the start() after the next
    join(), so it stays the caller's until then. The parse runs on a
    native worker thread of its own (native.ParseWorker, one C call a
    chunk), or with n_threads > 1 on a thread pool, one C call per
    contiguous lane block and chunk (each worker owns its parsers and its
    rows: GIL-free, byte-identical to serial,
    go_mp3_tpu/parallel/corpus.py:432-463). Its seconds go to the span
    gomp3.corpus.parse at the join (spans.record) and to `seconds`."""

    def __init__(self, streams, k, chunk_t, groups, n_threads):
        n = len(streams)
        self.groups = groups
        self.rows = [_Rows(np.empty((k, n, chunk_t, SP8_TAIL_WIDTH), np.int8),
                           np.empty((k, n, chunk_t, HEAD_WIDTH), np.int16),
                           np.empty((k, n, chunk_t, SIDE8_WIDTH), np.uint8),
                           np.zeros((k, n), np.int32)) for _ in range(2)]
        self.batch = BatchParser(streams)
        self.seconds = 0.0
        self._next = 0  # the pool the next start() fills
        self._flight = None  # the parse in flight: the call that waits for its result
        self._joins = 0
        if n_threads > 1:
            w = min(n_threads, n)
            bounds = [round(i * n / w) for i in range(w + 1)]
            self.blocks = list(zip(bounds, bounds[1:]))
            self.pool, self.worker = ThreadPoolExecutor(max_workers=w), None
        else:
            self.pool, self.worker = None, ParseWorker()

    def start(self) -> None:
        """Begin parsing the next segment into the free pool."""
        rows = self.rows[self._next]
        if self.pool is None:
            self.worker.start_many(self.batch, *rows)
            self._flight = self.worker.join_many
        else:
            rows.valids[:] = 0
            futures = [self.pool.submit(self._parse_block, rows, lo, hi)
                       for lo, hi in self.blocks]
            self._flight = lambda: self._gather(futures)

    def _parse_block(self, rows: _Rows, lo: int, hi: int):
        """Lanes [lo, hi) of every chunk of the segment, on a pool thread:
        (each chunk's most granules, until the error that stopped it, the
        error or None, start and end on the host clock)."""
        t0, most, err = time.perf_counter(), [], None
        for c in range(len(rows.valids)):
            try:
                most.append(self.batch.parse_chunk_into(
                    rows.tail[c], rows.head[c], rows.side[c], rows.valids[c], lo=lo, hi=hi))
            except (ValueError, OverflowError) as e:
                err = e
                break
        return most, err, t0, time.perf_counter()

    def _wait(self) -> tuple[int, float, Exception | None]:
        """(chunks with any granule before the stop, the parse's seconds, the
        error that stopped it or None) of the parse in flight."""
        flight, self._flight = self._flight, None
        return flight()

    def _gather(self, futures) -> tuple[int, float, Exception | None]:
        """_wait's result from the lane blocks' futures."""
        blocks = [f.result() for f in futures]
        seconds = max(b[3] for b in blocks) - min(b[2] for b in blocks)
        for c in range(len(self.rows[0].valids)):
            # the first block in order that stopped at chunk c raises, as
            # the serial loop over the blocks' futures would
            err = next((e for most, e, _, _ in blocks if e and len(most) == c), None)
            if err or not any(most[c] for most, _, _, _ in blocks):
                return c, seconds, err
        return len(self.rows[0].valids), seconds, None

    def join(self) -> tuple[int, _Rows]:
        """Wait for the parse started last -> (chunks with any granule, less
        than k once every stream has ended, the valid counts of the chunks
        past it 0; the pool it filled). Its error raises here as the serial
        parse raised it: after the chunks before it are checked, a
        ValueError naming the stream, or OverflowError for an int8 tail;
        _MonoSplitMismatch where a lane of a mono group holds a stereo
        granule."""
        rows = self.rows[self._next]
        self._next ^= 1
        with spans.span("gomp3.corpus.parse_wait"):
            n_seg, seconds, err = self._wait()
        self.seconds += seconds
        spans.record("gomp3.corpus.parse", seconds)
        if n_seg and self._joins:  # every segment but the first was parsed ahead
            spans.count("gomp3.corpus.prefetched")
        self._joins += 1
        for c in range(n_seg):
            for g in self.groups:
                if g.mono and not chunk_all_mono(rows.side[c, g.lo:g.hi],
                                                 rows.valids[c, g.lo:g.hi]):
                    raise _MonoSplitMismatch()
        if err is not None:
            raise err
        return n_seg, rows

    def close(self) -> None:
        """Wait for a parse in flight, its result unread, then free the
        threads and the parsers."""
        if self._flight is not None:
            self._wait()
        if self.pool is not None:
            self.pool.shutdown(wait=True)
        self.worker = None
        self.batch.close()


class _Shard:
    """One mesh entry of the fused path: its device, its lane groups (indices
    into the run's groups), their states, and on the card with drain its
    static SegmentGraph slots and graphs (one per width tuple)."""

    def __init__(self, device, lo, hi, group_idx, groups, order, k, t,
                 fetch, use_graph):
        self.device, self.lo, self.n = device, lo, hi - lo
        self.gidx = group_idx
        sizes = tuple(groups[j].hi - groups[j].lo for j in group_idx)
        self.monos = tuple(groups[j].mono for j in group_idx)
        self.states = tuple(init_state(s, device) for s in sizes)
        self.slots = static_slots(k, t, sizes, device) if use_graph else None
        self.graphs: dict = {}
        # fetch=False: each group's lanes at their place in this entry's
        # caller-order block, and the caller-order rows of every chunk
        self.caller_idx = [] if fetch else [
            torch.tensor([order[i] - lo for i in range(groups[j].lo, groups[j].hi)],
                         device=device)
            for j in group_idx]
        self.kept: list[torch.Tensor] = []


def _decode_fused(streams, chunk_t, fetch, drain, tail_buckets, n_threads,
                  mesh: Mesh, sharded: bool, split: bool):
    n_streams = len(streams)
    blocks = mesh.blocks(n_streams)
    pinned = any(d.type == "cuda" for d in mesh.devices)
    timer = _Timer()
    t = chunk_t

    # lane groups, per mesh entry: its stereo lanes first, then its mono
    # lanes (run_fused, :503-536, within each lane block)
    flags = ([_mono_first_frame(d) for d in streams] if split
             else [False] * n_streams)
    order: list[int] = []
    groups: list[_Group] = []
    for shard, (_, lo, hi) in enumerate(blocks):
        for mono in (False, True):
            lanes = [i for i in range(lo, hi) if flags[i] == mono]
            if lanes:
                groups.append(_Group(len(order), len(order) + len(lanes), mono, shard))
                order += lanes
    sizes = tuple(g.hi - g.lo for g in groups)
    segmented = drain is not None and fetch
    k = drain if segmented else 1

    def host_set():
        """Pinned rows for one segment: the wire stacks (sized for the
        full width, viewed at the segment's), valids and PCM per group."""
        return {
            "wire": [torch.empty(k * s * stream_nbytes(t, TAIL_LINES_FULL, g.mono),
                                 dtype=torch.uint8, pin_memory=pinned)
                     for s, g in zip(sizes, groups)],
            "valid": [torch.empty((k, s), dtype=torch.int32, pin_memory=pinned)
                      for s in sizes],
            "pcm": [torch.empty((k, s, t * SAMPLES_PER_GR, 2), dtype=torch.int16,
                                pin_memory=pinned) for s in sizes] if fetch else None,
            "copied": [],
        }

    parser = _SegmentParser([streams[i] for i in order], k, t, groups, n_threads)
    parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    valid_rows = []  # fetch=False: internal-order valids per chunk
    widths_log, wire_bytes, total, mono_total, slots, capture_s = [], 0, 0, 0, 0, 0.0
    replays0 = SegmentGraph.replays
    pending = None  # (host set, valids [k, S] internal, chunks, D2H events)

    def emit(hs, valids, n_seg, done) -> None:
        with spans.span("gomp3.corpus.wait"):
            for ev in done:
                ev.synchronize()
        with timer.span("emit"):
            for g, pcm in zip(groups, hs["pcm"]):
                host = pcm.numpy()
                for c in range(n_seg):
                    for s in range(g.lo, g.hi):
                        v = int(valids[c, s])
                        if v:
                            parts[order[s]].append(
                                host[c, s - g.lo, : v * SAMPLES_PER_GR].tobytes())

    def run_shard(sh: _Shard, hs, wires, widths, n_seg, done) -> None:
        """Entry sh's part of a segment: H2D of its rows, its groups
        decoded on its device, and (fetch) the D2H of its PCM."""
        nonlocal capture_s
        dev = sh.device
        w_sh = tuple(widths[j] for j in sh.gidx)
        rows = [wires[j] for j in sh.gidx]
        vbufs = [hs["valid"][j] for j in sh.gidx]
        e0 = timer.mark(dev)
        if sh.slots is not None:
            graph = sh.graphs.get(w_sh)
            if graph is None:
                graph = sh.graphs[w_sh] = SegmentGraph(t, w_sh, sh.monos, *sh.slots)
                e0 = timer.mark(dev)  # capture is set-up, not h2d
                capture_s += graph.capture_seconds
            for dst, src in zip(graph.bufs, rows):
                dst.copy_(src, non_blocking=True)
            for dst, src in zip(sh.slots[0], vbufs):
                dst.copy_(src, non_blocking=True)
            e1 = timer.mark(dev)
            graph.replay()
            pcm_dev = sh.slots[2]
        else:
            bufs_dev = [w.to(dev, non_blocking=True) for w in rows]
            valids_dev = [v.to(dev, non_blocking=True) for v in vbufs]
            e1 = timer.mark(dev)
            pcm_dev, sh.states = run_segment_eager(
                bufs_dev, valids_dev, sh.states, t, w_sh, sh.monos)
        if not fetch:  # caller-order rows of this entry, on its device
            for c in range(n_seg):
                out = torch.empty((sh.n, t * SAMPLES_PER_GR, 2),
                                  dtype=torch.int16, device=dev)
                for idx, pcm in zip(sh.caller_idx, pcm_dev):
                    out.index_copy_(0, idx, pcm[c])
                sh.kept.append(out)
        e2 = timer.mark(dev)
        if dev.type == "cuda":
            hs["copied"].append(e1)
        timer.add("h2d", e0, e1)
        timer.add("kernels", e1, e2)
        if fetch:
            for j, src in zip(sh.gidx, pcm_dev):
                hs["pcm"][j].copy_(src, non_blocking=True)
            e3 = timer.mark(dev)
            timer.add("d2h", e2, e3)
            if dev.type == "cuda":
                done.append(e3)

    try:
        parser.start()  # segment 0 parses while the entries and host sets are made
        shards = [
            _Shard(dev, lo, hi, [j for j, g in enumerate(groups) if g.shard == i],
                   groups, order, k, t, fetch, segmented and dev.type == "cuda")
            for i, (dev, lo, hi) in enumerate(blocks)
        ]
        # a set is refilled only after every entry's H2D copies of it completed
        sets = (host_set(), host_set())
        for seg in itertools.count():
            hs = sets[seg % 2]
            with spans.span("gomp3.corpus.wait"):
                for ev in hs["copied"]:
                    ev.synchronize()
            n_seg, rows = parser.join()
            if n_seg == 0:
                break
            if n_seg == k:  # the next segment parses while this one is packed and shipped
                parser.start()

            # widths: per chunk (k = 1), or per segment with drain, the
            # bucket of the largest exact extent; then the wire rows
            with timer.span("pack"):
                widths = tuple(
                    bucket_tail_lines(
                        max(tail_need_lines(rows.tail[c, g.lo:g.hi])
                            for c in range(n_seg)),
                        tail_buckets)
                    if tail_buckets else TAIL_LINES_FULL
                    for g in groups
                )
                wires = []
                for g, w, flat, vbuf in zip(groups, widths, hs["wire"], hs["valid"]):
                    wire = flat[: k * (g.hi - g.lo) * stream_nbytes(t, w, g.mono)]
                    wire = wire.view(k, g.hi - g.lo, -1)
                    build = build_fused_chunk_mono if g.mono else build_fused_chunk
                    for c in range(n_seg):
                        build(rows.tail[c, g.lo:g.hi], rows.head[c, g.lo:g.hi],
                              rows.side[c, g.lo:g.hi], w, out=wire[c].numpy())
                    wire[n_seg:] = 0  # padding chunks of a short last segment
                    vbuf.numpy()[:] = rows.valids[:, g.lo:g.hi]
                    wires.append(wire)
                    wire_bytes += wire.numel()
                    if g.mono:
                        mono_total += int(vbuf.numpy().sum())
                widths_log += [widths] * n_seg
                valids = rows.valids.copy()
                total += int(valids.sum())
                slots += k * n_streams * t  # a short last segment's padding chunks too

            hs["copied"], done = [], []
            for sh in shards:
                run_shard(sh, hs, wires, widths, n_seg, done)
            if fetch:
                if pending is not None:
                    emit(*pending)
                pending = (hs, valids, n_seg, done)
            else:
                valid_rows += list(valids[:n_seg])
            if n_seg < k:
                break
        if pending is not None:
            emit(*pending)
    finally:
        parser.close()
    timer.host["parse"] = parser.seconds

    if valid_rows:
        pcm_dev = _device_result([sh.kept for sh in shards], sharded)
    with spans.span("gomp3.corpus.wait"):
        _synchronize(mesh.devices)
    with timer.span("emit"):
        pcm = [b"".join(p) for p in parts]
    _count_returned(total, mono_total, wire_bytes, slots)
    res = CorpusResult(
        pcm=pcm,
        granules=total,
        samples=total * SAMPLES_PER_GR,
        phase_seconds=timer.seconds(),
        chunk_widths=widths_log,
        wire_bytes=wire_bytes,
        graph_replays=SegmentGraph.replays - replays0,
        graph_capture_seconds=capture_s,
    )
    if fetch or not valid_rows:
        return res
    internal = np.stack(valid_rows)
    caller = np.empty_like(internal)
    caller[:, order] = internal
    return DeviceCorpus(pcm_dev, caller, res)
