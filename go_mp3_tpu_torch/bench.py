"""Benchmark: aggregate MP3 decode throughput on one card.

    python -m go_mp3_tpu_torch.bench [--device cuda|cpu]

The counterpart of bench.py (the JAX package's bench, :102-828), with its
corpus size, pipeline schedules, protocol and JSON line. Pipeline: the C++
parser fills a reused pool of [S, T] chunk arrays (int8 tail, int16 head,
byte sidecar); the host packs each chunk into one fused wire row per lane
(ops/wire.py), a stereo and a half-width mono lane group, the tail capped
per chunk at the bucket of its nonzero lines; the rows reach the card in
pinned host buffers; the corpus program (parallel/corpus_scan.py) decodes
every chunk with the state carried, through the chain kernel, and reduces
each chunk's PCM to per-lane energies with the energy kernel, so that no
PCM leaves the card. The program is captured once as a CUDA graph before
anything is timed (capture_s), as bench.py compiles its scan ahead of time.
The timed region ends with the fetch of the [C, S] energies, the fence.

Four schedules, each measured, the best carrying the headline:
  strict       parse and pack every chunk, then one copy per chunk and
               lane group, then one replay;
  overlap      each chunk's copies enqueued on a copy stream as soon as it
               is packed, under the parse of the next;
  strict_mega  one copy per run of equal-width chunks and lane group;
  pipelined    every chunk at the corpus-global width, decoded as two
               half-corpus graphs: the second half's copies run on the copy
               stream under the first half's replay, ordered by an event.
All four decode the same granules, so their energies must be equal.

Protocol (bench.py:605-639): three rounds over the schedules, round-robin,
with GOMP3_RUN_BUDGET_S as the escape (each schedule keeps two runs);
headline = the best schedule's fastest run, every run's wall in detail.
Untimed probes afterwards: the full-corpus parse (process CPU and wall,
min and median over separated samples), the pack, the upload of one
chunk, the scan-amortized compute (the corpus graph replayed on resident
rows, the fastest of 5), and the D2H rate of one lane's PCM. The three
decoder ceilings are computed from those probes as bench.py computes them:
arithmetic on probes, not measurements.

Corpus: tools/corpus.py corpus_lanes (GOMP3_N_CLASSIC lanes of
conformance/synthetic_escape.mp3 x128, then GOMP3_N_MPEG2 lanes of
conformance/synthetic_lowrate.mp3 x110, the mono group at the tail), the
size of bench.py's corpus, whose fixtures are not in the repo. Knobs are
bench.py's: GOMP3_N_CLASSIC (48), GOMP3_N_MPEG2 (16), GOMP3_CHUNK_T (240),
GOMP3_TAIL_BUCKETS (464,512), GOMP3_MONO_SPLIT (1), GOMP3_SCHEDULES (all),
GOMP3_RUN_BUDGET_S (300). On the card unless --device cpu, where the same
program runs eagerly through the kernels' plain versions (no graph, no
pinned memory; its times are the CPU's, not the card's).

Prints one JSON line on stdout (bench.py's keys, numbers unrounded; no
vs_baseline, which divided by a TPU target; d2h_mb_s for bench.py's
d2h_tunnel_mb_s; host_cores counted; device, card and capture_s added);
diagnostics on stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .consts import HEAD_WIDTH, SAMPLES_PER_GR, SIDE8_WIDTH, SP8_TAIL_WIDTH
from .device import resolve_device
from .native.lib import BatchParser, NativeParser
from .ops import kernels as K
from .ops.granule import init_state
from .ops.wire import (
    TAIL_LINES_FULL,
    build_fused_chunk,
    build_fused_chunk_mono,
    chunk_all_mono,
    stream_nbytes,
    tail_cap_lines,
)
from .parallel.corpus_scan import CorpusGraph, Group, decode_energies
from .tools.cardtime import card_identity
from .tools.corpus import ESCAPE, LOWRATE, N_MONO, N_STEREO, corpus_lanes

SCHEDULES = ("overlap", "strict", "strict_mega", "pipelined")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass(frozen=True)
class Settings:
    """bench.py's knobs (:141-161, :292-304, :615), with its defaults."""

    n_escape: int = N_STEREO
    n_lowrate: int = N_MONO
    chunk_t: int = 240
    tail_buckets: tuple[int, ...] | None = (464, 512)
    mono_split: bool = True
    schedules: tuple[str, ...] = SCHEDULES
    run_budget_s: float = 300.0

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        buckets = tuple(int(b) for b in env.get("GOMP3_TAIL_BUCKETS", "464,512").split(",")
                        if b)
        sel = [s.strip() for s in env.get("GOMP3_SCHEDULES", ",".join(SCHEDULES)).split(",")
               if s.strip()]
        for s in sel:
            if s not in SCHEDULES:
                log(f"WARNING: unknown schedule {s!r} in GOMP3_SCHEDULES "
                    f"(valid: {', '.join(SCHEDULES)})")
        return cls(
            n_escape=int(env.get("GOMP3_N_CLASSIC", str(N_STEREO))),
            n_lowrate=int(env.get("GOMP3_N_MPEG2", str(N_MONO))),
            chunk_t=int(env.get("GOMP3_CHUNK_T", "240")),
            tail_buckets=buckets or None,
            mono_split=env.get("GOMP3_MONO_SPLIT", "1") == "1",
            schedules=tuple(m for m in SCHEDULES if m in sel) or ("strict",),
            run_budget_s=float(env.get("GOMP3_RUN_BUDGET_S", "300")),
        )


@dataclass(frozen=True)
class Geometry:
    """Per-lane granule counts and sample rates, and the corpus's chunk
    count at chunk_t, counted with chunk-sized parse calls (bench.py:173-
    202): a chunk of MPEG-2 LSF lanes (one granule a frame) holds at most
    chunk_t - 1 granules, since the parser keeps two slots free a frame, so
    ceil(granules / chunk_t) can undercount."""

    n_chunks: int
    granules: tuple[int, ...]
    rates: tuple[int, ...]

    @property
    def total_granules(self) -> int:
        return sum(self.granules)

    @property
    def audio_seconds(self) -> float:
        return sum(g * SAMPLES_PER_GR / sr for g, sr in zip(self.granules, self.rates))


def geometry(lanes: list[bytes], chunk_t: int) -> Geometry:
    tail = np.zeros((chunk_t, SP8_TAIL_WIDTH), np.int8)
    head = np.zeros((chunk_t, HEAD_WIDTH), np.int16)
    side = np.zeros((chunk_t, SIDE8_WIDTH), np.uint8)
    granules, rates, n_chunks = [], [], 0
    for data in lanes:
        p = NativeParser(data)
        try:
            total, calls = 0, 0
            while n := p.parse_packed8_into(tail, head, side):
                total += n
                calls += 1
            granules.append(total)
            rates.append(p.sample_rate)
        finally:
            p.close()
        n_chunks = max(n_chunks, calls)
    return Geometry(n_chunks, tuple(granules), tuple(rates))


def alloc_pool(n_chunks: int, n_streams: int, chunk_t: int):
    """The parse pool: per chunk, the C++ parser's (tail int8, head int16,
    sidecar u8) arrays [S, T, ...], allocated once and reused (fresh pages
    every run would be measured as parse time)."""
    return [(np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8),
             np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16),
             np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8)) for _ in range(n_chunks)]


def parse_sample(lanes: list[bytes], pool, valids: np.ndarray) -> tuple[float, float]:
    """Parse every chunk of every lane into the pool (valids int32 [C, S]
    receives the counts) -> (wall s, process CPU s): one sample of the
    full-corpus parse probe (bench.py:224-233)."""
    bp = BatchParser(lanes)
    try:
        t0, c0 = time.perf_counter(), time.process_time()
        for (tail, head, side), v in zip(pool, valids):
            bp.parse_chunk_into(tail, head, side, v)
        return time.perf_counter() - t0, time.process_time() - c0
    finally:
        bp.close()


def lane_groups(n_streams: int, n_stereo: int) -> tuple[Group, ...]:
    """The stereo lanes [0, n_stereo), then the mono lanes (bench.py's
    n_stereo split, :161), each group present only if it has lanes."""
    return tuple(g for g in (Group(0, n_stereo, False), Group(n_stereo, n_streams, True))
                 if g.hi > g.lo)


def chunk_widths(pool, groups, buckets) -> list[tuple[int, ...]]:
    """Per chunk, each group's tail cap: the bucket of the chunk's nonzero
    tail lines (bench.py:242-256), or the full 512 without buckets."""
    return [tuple(tail_cap_lines(tail[g.lo:g.hi], buckets) if buckets else TAIL_LINES_FULL
                  for g in groups)
            for tail, _, _ in pool]


def equal_width_runs(widths) -> list[tuple[tuple[int, ...], int, int]]:
    """Runs of consecutive chunks of equal widths: (widths, lo, hi)
    (bench.py's runs_idx, :333-338)."""
    runs, lo = [], 0
    for c in range(1, len(widths) + 1):
        if c == len(widths) or widths[c] != widths[lo]:
            runs.append((widths[lo], lo, c))
            lo = c
    return runs


def group_bytes(groups, chunk_t: int, widths) -> int:
    """Wire bytes of one chunk at `widths`, every group."""
    return sum((g.hi - g.lo) * stream_nbytes(chunk_t, w, g.mono) for g, w in zip(groups, widths))


class Stacked(NamedTuple):
    """n chunks of [rows, row_bytes] u8 rows in one flat buffer, each
    chunk's rows at a 16-byte aligned offset (the wire rows' row_bytes need
    not be a multiple of 16): one copy moves them all, and each chunk's
    view starts where K1's wire loads are widest."""

    flat: torch.Tensor
    views: list[torch.Tensor]

    @classmethod
    def alloc(cls, n: int, rows: int, row_bytes: int, make) -> "Stacked":
        stride = -(-rows * row_bytes // 16) * 16
        flat = make(n * stride)
        views = [flat[i * stride:i * stride + rows * row_bytes].view(rows, row_bytes)
                 for i in range(n)]
        for v in views:
            if v.data_ptr() % 16:
                raise ValueError("wire rows not 16-byte aligned")
        return cls(flat, views)


class BenchRun(NamedTuple):
    """One bench: its JSON object, the energies int32 [C, S] (every run's)
    and the valid counts int32 [C, S] of the chunks."""

    result: dict
    energies: np.ndarray
    valids: np.ndarray


class Bench:
    """bench.py's pipeline on one device, set up untimed: the geometry, the
    parse pool, the tail caps, the host rows (pinned on the card) and their
    device twins, and the corpus program (CUDA graphs on the card)."""

    def __init__(self, lanes: list[bytes], settings: Settings, device: torch.device):
        self.lanes, self.settings, self.device = lanes, settings, device
        self.cuda = device.type == "cuda"
        t, n = settings.chunk_t, len(lanes)
        self.geo = geometry(lanes, t)
        n_chunks = self.geo.n_chunks
        n_stereo = settings.n_escape if settings.mono_split and settings.n_lowrate else n
        self.groups = lane_groups(n, n_stereo)

        self.pool = alloc_pool(n_chunks, n, t)
        self.parse_wall: list[float] = []
        self.parse_cpu: list[float] = []
        self.parse_probe(3, check_mono=True)  # also warms the pool's pages

        self.widths = chunk_widths(self.pool, self.groups, settings.tail_buckets)
        self.w_glob = tuple(max(w[j] for w in self.widths) for j in range(len(self.groups)))
        self.n_even = n_chunks + n_chunks % 2  # two equal halves for `pipelined`
        self.runs = equal_width_runs(self.widths)
        self.wire_bytes = sum(group_bytes(self.groups, t, w) for w in self.widths)

        # host rows (pinned on the card: a non_blocking copy from pageable
        # memory is synchronous) and their device twins, run-stacked: one
        # layout serves strict, overlap and strict_mega, only the copies
        # differ. `pipelined` has its own at the corpus-global width, padding
        # chunk included (all zero, valid 0).
        def host(nb):
            return torch.zeros(nb, dtype=torch.uint8, pin_memory=self.cuda)

        def dev(nb):
            return torch.zeros(nb, dtype=torch.uint8, device=device)

        def stacks(k, widths, make):
            return [Stacked.alloc(k, g.hi - g.lo, stream_nbytes(t, w, g.mono), make)
                    for g, w in zip(self.groups, widths)]

        self.host_runs = [stacks(hi - lo, w, host) for w, lo, hi in self.runs]
        self.dev_runs = [stacks(hi - lo, w, dev) for w, lo, hi in self.runs]
        self.host_chunks, self.dev_chunks = [], []
        for r, (_, lo, hi) in enumerate(self.runs):
            for c in range(hi - lo):
                self.host_chunks.append([s.views[c] for s in self.host_runs[r]])
                self.dev_chunks.append([s.views[c] for s in self.dev_runs[r]])
        self.host_np = [[v.numpy() for v in vs] for vs in self.host_chunks]
        self.pipelined = "pipelined" in settings.schedules
        if self.pipelined:
            self.host_pipe = stacks(self.n_even, self.w_glob, host)
            self.dev_pipe = stacks(self.n_even, self.w_glob, dev)
            self.pipe_np = [[s.views[c].numpy() for s in self.host_pipe]
                            for c in range(n_chunks)]
        self.valids_host = torch.zeros((self.n_even, n), dtype=torch.int32,
                                       pin_memory=self.cuda)
        self.valids_dev = torch.zeros((self.n_even, n), dtype=torch.int32, device=device)
        self.energies = torch.zeros((self.n_even, n), dtype=torch.int32, device=device)
        self.states = tuple(init_state(g.hi - g.lo, device) for g in self.groups)
        self.scratch = tuple(torch.empty((g.hi - g.lo, t * SAMPLES_PER_GR, 2),
                                         dtype=torch.int16, device=device)
                             for g in self.groups)
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None

        self.capture_s = 0.0
        self.corpus = self.program(self.dev_chunks, self.valids_dev[:n_chunks],
                                   self.energies[:n_chunks], self.widths)
        log(f"corpus program: {n_chunks} chunks x {len(self.groups)} lane groups, "
            f"capture {self.capture_s:.3f} s (one-time, untimed)")
        self.parse_probe(1)  # a separated sampling point
        # warm the host rows' pages untimed
        for c in range(n_chunks):
            self.pack(c, self.host_np[c], self.widths[c])
            if self.pipelined:
                self.pack(c, self.pipe_np[c], self.w_glob)
        if self.pipelined:
            k = self.n_even // 2
            self.halves = [
                self.program([[s.views[c] for s in self.dev_pipe] for c in range(h, h + k)],
                             self.valids_dev[h:h + k], self.energies[h:h + k],
                             [self.w_glob] * k)
                for h in (0, k)]
            log(f"half-corpus programs: 2 x {k} chunks at {self.w_glob} (capture "
                f"{self.capture_s:.3f} s in all)")

    def program(self, chunks, valids, energies, widths):
        """The corpus program over these static buffers, the states
        carried in self.states: a CorpusGraph's replay on the card, an
        eager decode_energies on the CPU."""
        args = (chunks, valids, self.states, energies, self.groups, self.settings.chunk_t,
                widths, self.scratch)
        if self.cuda:
            graph = CorpusGraph(*args)
            self.capture_s += graph.capture_seconds
            return graph.replay

        def run():
            for st, new in zip(self.states, decode_energies(*args)):
                st.store.copy_(new.store)
                st.v_fifo.copy_(new.v_fifo)
        return run

    # -- host steps --------------------------------------------------------

    def parse_probe(self, reps: int, check_mono: bool = False) -> None:
        """Parse every chunk of every lane into the pool, `reps` times, each
        sample's wall and process CPU time kept (bench.py:224-233).
        check_mono: every valid granule of the mono group is mono (its
        wire carries channel 0 alone)."""
        valids = np.zeros((len(self.pool), len(self.lanes)), np.int32)
        for _ in range(reps):
            wall, cpu = parse_sample(self.lanes, self.pool, valids)
            self.parse_wall.append(wall)
            self.parse_cpu.append(cpu)
        if not check_mono:
            return
        for g in (g for g in self.groups if g.mono):
            for (_, _, side), v in zip(self.pool, valids):
                if not chunk_all_mono(side[g.lo:g.hi], v[g.lo:g.hi]):
                    raise ValueError("a lane of the mono group holds a stereo granule")

    def pack(self, c: int, outs, widths) -> None:
        """Pool chunk c -> its fused rows, one array per group in `outs`."""
        tail, head, side = self.pool[c]
        for g, out, w in zip(self.groups, outs, widths):
            build = build_fused_chunk_mono if g.mono else build_fused_chunk
            build(tail[g.lo:g.hi], head[g.lo:g.hi], side[g.lo:g.hi], w, out=out)

    # -- device steps ------------------------------------------------------

    def _on_copy_stream(self):
        return torch.cuda.stream(self.copy_stream) if self.cuda else nullcontext()

    def _reset_states(self) -> None:
        for st in self.states:
            st.store.zero_()
            st.v_fifo.zero_()

    def _fetch(self, rows: slice) -> np.ndarray:
        """The energies' D2H copy: the fence (a synchronous copy)."""
        return self.energies[rows].cpu().numpy()

    def one_run(self, mode: str):
        """One timed run of a schedule -> (wall s, parse+pack wall s,
        energies int32 [C, S])."""
        n_chunks = self.geo.n_chunks
        pipelined = mode == "pipelined"
        self._reset_states()
        valids = self.valids_host.numpy()
        if self.cuda:  # copies into the device rows wait for earlier reads
            self.copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        t_start = time.perf_counter()
        bp = BatchParser(self.lanes)
        valids[:] = 0
        t0 = time.perf_counter()
        for c in range(n_chunks):
            tail, head, side = self.pool[c]
            bp.parse_chunk_into(tail, head, side, valids[c])
            if pipelined:
                self.pack(c, self.pipe_np[c], self.w_glob)
                continue
            self.pack(c, self.host_np[c], self.widths[c])
            if mode == "overlap":
                with self._on_copy_stream():
                    for dst, src in zip(self.dev_chunks[c], self.host_chunks[c]):
                        dst.copy_(src, non_blocking=True)
        parse_wall = time.perf_counter() - t0
        bp.close()
        if int(valids.sum()) != self.geo.total_granules:
            raise RuntimeError(f"parsed {int(valids.sum())} granules, expected "
                               f"{self.geo.total_granules}")
        self.valids_dev.copy_(self.valids_host, non_blocking=True)
        if pipelined:
            for src, dst in zip(self.host_pipe, self.dev_pipe):
                dst.flat[:dst.flat.numel() // 2].copy_(src.flat[:src.flat.numel() // 2],
                                                        non_blocking=True)
            self.halves[0]()
            with self._on_copy_stream():  # the second half's rows under the first's replay
                for src, dst in zip(self.host_pipe, self.dev_pipe):
                    dst.flat[dst.flat.numel() // 2:].copy_(src.flat[src.flat.numel() // 2:],
                                                            non_blocking=True)
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_stream(self.copy_stream)
            self.halves[1]()
            en = self._fetch(slice(0, n_chunks))
            return time.perf_counter() - t_start, parse_wall, en
        if mode == "strict":
            for dsts, srcs in zip(self.dev_chunks, self.host_chunks):
                for dst, src in zip(dsts, srcs):
                    dst.copy_(src, non_blocking=True)
        elif mode == "strict_mega":
            for dsts, srcs in zip(self.dev_runs, self.host_runs):
                for dst, src in zip(dsts, srcs):
                    dst.flat.copy_(src.flat, non_blocking=True)
        elif self.cuda:  # overlap: the copies were enqueued on the copy stream
            torch.cuda.current_stream(self.device).wait_stream(self.copy_stream)
        self.corpus()
        en = self._fetch(slice(0, n_chunks))
        return time.perf_counter() - t_start, parse_wall, en

    # -- the protocol, the probes and the result ---------------------------

    def run(self) -> BenchRun:
        s, geo = self.settings, self.geo
        t, n_chunks, n = s.chunk_t, geo.n_chunks, len(self.lanes)
        audio = geo.audio_seconds
        log(f"device {self.device}; {n} lanes, {geo.total_granules} granules, {audio:.2f} s "
            f"of audio, {n_chunks} chunks of {t}; tail caps per chunk {self.widths}")

        runs: dict[str, list] = {m: [] for m in s.schedules}
        first: tuple[str, np.ndarray] | None = None
        spent = 0.0
        order = [m for _ in range(3) for m in s.schedules]
        for rep, mode in enumerate(order):
            wall, parse_wall, en = self.one_run(mode)
            runs[mode].append((wall, parse_wall))
            spent += wall
            # the decode is deterministic: every run of every schedule gives
            # the same energies (this pins the pipelined state carry)
            if first is None:
                first = (mode, en)
            elif not np.array_equal(first[1], en):
                raise RuntimeError(f"schedule {mode} energies != {first[0]}'s")
            log(f"run {rep} [{mode}]: wall {wall:.4f} s (parse+pack {parse_wall:.4f} s inside)")
            if spent > s.run_budget_s and all(len(r) >= 2 for r in runs.values()):
                log(f"run budget {s.run_budget_s:.0f} s spent; stopping at {rep + 1}")
                break
        energies = first[1]
        valids = self.valids_host[:n_chunks].numpy().copy()
        best = {m: min(rs) for m, rs in runs.items() if rs}
        best_mode = min(best, key=lambda m: best[m][0])
        total_wall, parse_wall = best[best_mode]
        # non-silence fence: the sums wrap at large chunk_t, so test for
        # nonzero, not for sign
        if not (energies[:2] != 0).all():
            raise RuntimeError("every lane's first chunks should be non-silent")
        end_to_end = audio / total_wall

        # untimed probes
        self.parse_probe(3)  # separated sampling points
        c0 = time.process_time()
        for c in range(n_chunks):
            self.pack(c, self.host_np[c], self.widths[c])
        probe_pack = (time.process_time() - c0) / n_chunks

        # the upload of one chunk's rows (chunk 1 when there is one: chunk 0
        # holds the atypical first frames), synchronised
        t0 = time.perf_counter()
        up = [torch.empty_like(v, device=self.device).copy_(v, non_blocking=True)
              for v in self.host_chunks[min(1, n_chunks - 1)]]
        up[0][0, :4].cpu()
        probe_upload = time.perf_counter() - t0
        del up

        # scan-amortized compute: the corpus graph replayed on resident rows
        for dsts, srcs in zip(self.dev_runs, self.host_runs):
            for dst, src in zip(dsts, srcs):
                dst.flat.copy_(src.flat)
        self.valids_dev[:n_chunks] = t
        probe_scan = float("inf")
        for _ in range(5):
            self._reset_states()
            if self.cuda:
                torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self.corpus()
            self._fetch(slice(0, n_chunks))
            probe_scan = min(probe_scan, time.perf_counter() - t0)
        probe_compute = probe_scan / n_chunks
        self.parse_probe(2)  # the last sampling points

        parse_min, parse_med = min(self.parse_cpu), statistics.median(self.parse_cpu)
        compute_total = probe_compute * n_chunks
        pack_total = probe_pack * n_chunks
        ceiling = (audio / (parse_min + compute_total), audio / (parse_med + compute_total))
        ceiling_fused = (audio / (parse_min + pack_total + compute_total),
                         audio / (parse_med + pack_total + compute_total))
        ceiling_pipe = (audio / max(parse_min, compute_total),
                        audio / max(parse_med, compute_total))
        chunk_audio = sum(t * SAMPLES_PER_GR / sr for sr in geo.rates)
        log(f"full-corpus parse: cpu min {parse_min:.4f} s med {parse_med:.4f} s, wall min "
            f"{min(self.parse_wall):.4f} s over {len(self.parse_cpu)} samples; pack "
            f"{probe_pack:.4f} s/chunk; upload {probe_upload:.4f} s/chunk; compute "
            f"{probe_compute:.5f} s/chunk (scan {probe_scan:.4f} s / {n_chunks}); ceilings "
            f"(computed) {ceiling[0]:.0f}x / {ceiling_fused[0]:.0f}x fused / "
            f"{ceiling_pipe[0]:.0f}x pipelined")

        # validation probe: one chunk of group 0 decoded alone; its PCM past
        # the first frames (granules 20 .. 60, or the chunk's end) is not
        # silence
        if t <= 20:
            raise ValueError(f"chunk_t {t}: the validation probe needs more than 20 granules")
        g0 = self.groups[0]
        s0 = g0.hi - g0.lo
        pcm, _ = K.decode_chunk_fused(
            self.dev_chunks[0][0], init_state(s0, self.device),
            torch.full((s0,), t, dtype=torch.int32, device=self.device),
            t, self.widths[0][0], g0.mono)
        probe = pcm[0, 20 * SAMPLES_PER_GR:min(60, t) * SAMPLES_PER_GR].cpu()
        if not int(probe.abs().max()) > 100:
            raise RuntimeError("the decoded PCM of the validation probe is silence")
        t0 = time.perf_counter()
        lane = pcm[0].cpu()
        d2h = lane.numel() * lane.element_size() / 1e6 / (time.perf_counter() - t0)
        log(f"audio {audio:.2f} s, wall {total_wall:.4f} s [{best_mode}]: end to end "
            f"{end_to_end:.1f}x realtime; d2h {d2h:.0f} MB/s")

        n_groups = len(self.groups)
        wire_pipe = self.n_even * group_bytes(self.groups, t, self.w_glob)
        slots = n_chunks * n * t
        result = {
            "metric": "aggregate end-to-end decode throughput, 44.1kHz stereo",
            "value": end_to_end,
            "unit": "x realtime per chip",
            "detail": {
                # computed from the probes, not measured (bench.py:685-703)
                "decoder_ceiling_x_realtime": ceiling[0],
                "decoder_ceiling_x_realtime_median": ceiling[1],
                "decoder_ceiling_fused_x_realtime": ceiling_fused[0],
                "decoder_ceiling_fused_x_realtime_median": ceiling_fused[1],
                "decoder_ceiling_pipelined_x_realtime": ceiling_pipe[0],
                "decoder_ceiling_pipelined_x_realtime_median": ceiling_pipe[1],
                "parse_full_corpus_cpu_s": {"min": parse_min, "median": parse_med,
                                            "n": len(self.parse_cpu)},
                "parse_full_corpus_wall_s_min": min(self.parse_wall),
                "host_parse_x_realtime_cpu": audio / parse_min,
                "end_to_end_x_by_schedule": {m: audio / min(w for w, _ in rs)
                                             for m, rs in runs.items() if rs},
                "probe_pack_s_per_chunk": probe_pack,
                "probe_upload_s_per_chunk_fused": probe_upload,
                "probe_compute_s_per_chunk_scan_amortized": probe_compute,
                "probe_scan_total_s": probe_scan,
                "chunk_audio_seconds": chunk_audio,
                "wire_bytes_per_granule_effective": self.wire_bytes / slots,
                "wire_bytes_per_granule_pipelined": wire_pipe / slots,
                "tail_lines_corpus_global": list(self.w_glob),
                "tail_cap_lines_per_chunk": [list(w) for w in self.widths],
                "mono_split_lanes": sum(g.hi - g.lo for g in self.groups if g.mono),
                "tail_buckets": list(s.tail_buckets) if s.tail_buckets else None,
                "transfers_per_corpus_by_schedule": {
                    m: nt for m, nt in (("strict", n_chunks * n_groups),
                                        ("overlap", n_chunks * n_groups),
                                        ("strict_mega", len(self.runs) * n_groups),
                                        ("pipelined", 2 * n_groups))
                    if m in s.schedules},
                "schedule": best_mode,
                "runs_wall_s": {m: [w for w, _ in rs] for m, rs in runs.items()},
                "parse_pack_wall_in_best_run_s": parse_wall,
                "n_streams": n,
                "corpus": (f"{s.n_escape}x {ESCAPE.name} + {s.n_lowrate}x {LOWRATE.name} "
                           f"(conformance/), per-lane frame-boundary rotations "
                           f"(distinct content)"),
                "chunk_t": t,
                "n_chunks": n_chunks,
                "granules": geo.total_granules,
                "audio_seconds": audio,
                "d2h_mb_s": d2h,
                "host_cores": len(os.sched_getaffinity(0)),
                "device": str(self.device),
                "card": card_identity() if self.cuda else None,
                "capture_s": self.capture_s,
            },
        }
        return BenchRun(result, energies, valids)


def main(argv=None) -> BenchRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    settings = Settings.from_env()
    lanes = corpus_lanes(settings.n_escape, settings.n_lowrate)
    run = Bench(lanes, settings, device).run()
    print(json.dumps(run.result), flush=True)
    return run


if __name__ == "__main__":
    main()
