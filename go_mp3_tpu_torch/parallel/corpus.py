"""Multi-stream corpus decoding on one device: the throughput entry point.

Counterpart of decode_corpus_fast in go_mp3_tpu/parallel/corpus.py. The C++
parser fills one [S, T] chunk of every stream at a time into pinned host
buffers (the int8 interface: int8 tail, int16 head, byte sidecar); the chunk
is copied to the card asynchronously, K1 -> K2 -> K3 decode it with the
per-stream state carried on the card, and the PCM returns to pinned host
memory. Everything runs on one CUDA stream in order; the host parses chunk
c+1 while the card works on chunk c.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import torch

from go_mp3_tpu.consts import (
    HEAD_WIDTH,
    SAMPLES_PER_GR,
    SIDE8_WIDTH,
    SIDE_WIDTH,
    SP8_TAIL_WIDTH,
)
from go_mp3_tpu.native.lib import BatchParser, NativeParser

from ..device import resolve_device
from ..ops.granule import init_state
from ..ops.kernels import decode_chunk


@dataclass
class CorpusResult:
    pcm: list[bytes]  # per-stream s16le stereo PCM
    granules: int  # total granules decoded
    samples: int  # total output samples (per channel)
    # seconds by phase: "parse" and "emit" (PCM rows copied out of the
    # pinned buffers and joined per stream) on the host clock; "h2d",
    # "kernels", "d2h" as CUDA event time on the card's stream (host clock
    # on the CPU)
    phase_seconds: dict = field(default_factory=dict)


class _Timer:
    """Per-phase time: CUDA events on the stream for device phases (read
    once, at the end, so timing adds no synchronisation), the host clock
    otherwise."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host = dict.fromkeys(("parse", "h2d", "kernels", "d2h", "emit"), 0.0)
        self.events: list[tuple[str, object, object]] = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, phase: str, start, end) -> None:
        if self.cuda and phase in ("h2d", "kernels", "d2h"):
            self.events.append((phase, start, end))
        else:
            self.host[phase] += end - start

    def seconds(self) -> dict:
        out = dict(self.host)
        for phase, a, b in self.events:
            out[phase] += a.elapsed_time(b) / 1e3
        return out


def decode_corpus_fast(
    stream_bytes: list[bytes], chunk_t: int = 240, device=None
) -> CorpusResult:
    """Decode independent MP3 streams in lockstep [S, chunk_t] chunks.

    device: None means CUDA (raises where CUDA is unavailable); "cpu" runs
    the plain PyTorch chain. Streams whose tail spectra overflow the int8
    interface are decoded through the int16 interface instead (an input
    range path; the device path is the same)."""
    device = resolve_device(device)
    if not stream_bytes:
        return CorpusResult(pcm=[], granules=0, samples=0)
    try:
        return _decode(stream_bytes, chunk_t, device, int8=True)
    except OverflowError:
        return _decode(stream_bytes, chunk_t, device, int8=False)


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


def _decode(streams, chunk_t, device, int8: bool) -> CorpusResult:
    n_streams = len(streams)
    cuda = device.type == "cuda"
    timer = _Timer(device)
    source = (_Int8Chunks if int8 else _Int16Chunks)(streams)

    def host_buffers():
        arrays = tuple(
            torch.empty((n_streams, chunk_t, w), dtype=dt, pin_memory=cuda)
            for w, dt in source.widths
        )
        valid = torch.empty(n_streams, dtype=torch.int32, pin_memory=cuda)
        pcm = torch.empty(
            (n_streams, chunk_t * SAMPLES_PER_GR, 2), dtype=torch.int16,
            pin_memory=cuda,
        )
        return {"in": arrays, "valid": valid, "pcm": pcm, "copied": None}

    # two sets, so the host parses chunk c+1 while chunk c's copies run;
    # a set is refilled only after its H2D copies completed ("copied")
    bufs = (host_buffers(), host_buffers())
    parts: list[list[bytes]] = [[] for _ in range(n_streams)]
    state = init_state(n_streams, device)
    total = 0
    pending = None  # (pcm host buffer, valids, event marking its D2H done)

    def emit(pcm_host, valids, done) -> None:
        if done is not None:
            done.synchronize()
        t0 = time.perf_counter()
        host = pcm_host.numpy()
        for s in range(n_streams):
            v = int(valids[s])
            if v:
                parts[s].append(host[s, : v * SAMPLES_PER_GR].tobytes())
        timer.add("emit", t0, time.perf_counter())

    try:
        for c in itertools.count():
            buf = bufs[c % 2]
            if buf["copied"] is not None:
                buf["copied"].synchronize()
            t0 = time.perf_counter()
            valids = buf["valid"].numpy()
            valids[:] = 0
            source.parse(tuple(a.numpy() for a in buf["in"]), valids)
            timer.add("parse", t0, time.perf_counter())
            if not valids.any():
                break
            total += int(valids.sum())

            e0 = timer.mark()
            dev_in = tuple(a.to(device, non_blocking=True) for a in buf["in"])
            valid_dev = buf["valid"].to(device, non_blocking=True)
            e1 = timer.mark()
            buf["copied"] = e1 if cuda else None
            pcm_dev, state = decode_chunk(dev_in, state, valid_dev)
            e2 = timer.mark()
            buf["pcm"].copy_(pcm_dev, non_blocking=True)
            e3 = timer.mark()
            timer.add("h2d", e0, e1)
            timer.add("kernels", e1, e2)
            timer.add("d2h", e2, e3)

            if pending is not None:
                emit(*pending)
            pending = (buf["pcm"], valids.copy(), e3 if cuda else None)
        if pending is not None:
            emit(*pending)
    finally:
        source.close()
    if cuda:
        torch.cuda.current_stream(device).synchronize()
    t0 = time.perf_counter()
    pcm = [b"".join(p) for p in parts]
    timer.add("emit", t0, time.perf_counter())
    return CorpusResult(
        pcm=pcm,
        granules=total,
        samples=total * SAMPLES_PER_GR,
        phase_seconds=timer.seconds(),
    )
