"""K5: one k-chunk segment of the fused corpus path, with the state carried.

Counterpart of scan_fused and drain mode's scan_stacked in
go_mp3_tpu/parallel/corpus.py (:566-603, :672-675), over
decode_chunk_fused_batch_impl and its mono twin (go_mp3_tpu/ops/granule.py:
726-741): for each of k chunks and each lane group, one launch of the
chain kernel (kernels.decode_chunk_fused: K1 on the wire rows -> K2 -> K3,
x and x18 kept on chip), the per-group state carried from chunk to chunk.

Two forms of the same launch sequence:
 - run_segment_eager: a Python loop over chunks and lane groups. It is the
   plain form (on CPU tensors the wrapper runs the plain chain) and the
   non-drain corpus path on the card.
 - SegmentGraph: the sequence captured once into a torch.cuda.CUDAGraph
   over static buffers and replayed once per segment, the counterpart of
   JAX's one compiled k-chunk scan. The compute stays in the chain kernel;
   the graph removes the per-launch host dispatch (one launch per chunk
   and group).

A lane group is a (lanes, mono) pair: mono groups ship the half-width wire
(ops/wire.py). Padding chunks carry valid = 0, which leaves the state as it
was (the chain kernel keeps it), so a short last segment is padded with them.
"""

from __future__ import annotations

import time

import torch

from ..consts import SAMPLES_PER_GR

from ..ops import kernels as K
from ..ops.granule import init_state
from ..ops.wire import stream_nbytes


def run_segment_eager(bufs, valids, states, t: int, widths, monos, pcm=None):
    """bufs[g] u8 [k, S_g, wire.stream_nbytes(t, widths[g], monos[g])],
    valids[g] int32 [k, S_g], states[g] a DecodeState of S_g streams ->
    (pcm per group int16 [k, S_g, t*576, 2], states after the segment).
    `pcm`, if given, is a tuple of such tensors that receives the PCM."""
    if pcm is None:
        pcm = tuple(
            torch.empty((b.shape[0], b.shape[1], t * SAMPLES_PER_GR, 2),
                        dtype=torch.int16, device=b.device)
            for b in bufs
        )
    states = list(states)
    for c in range(bufs[0].shape[0]):
        for g, buf in enumerate(bufs):
            _, states[g] = K.decode_chunk_fused(
                buf[c], states[g], valids[g][c], t, widths[g], monos[g],
                out=pcm[g][c],
            )
    return pcm, tuple(states)


class SegmentGraph:
    """run_segment_eager captured as one CUDA graph.

    valids, states and pcm are static per-group buffers that every graph of
    a corpus run shares (so the carried state passes from one graph to the
    next when the segment widths change); the input rows `bufs` are this
    graph's own, sized for its widths. Before each replay the caller copies
    the segment's rows into `bufs` and its valid counts into `valids`; the
    replay writes the PCM into `pcm`, and its last nodes copy the new state
    into `states`, so the carry never leaves the card.

    Capture records the kernel wrappers' launches without running them;
    each replay adds them to the wrappers' counts (kernels.all_counts()),
    and to `replays`."""

    replays = 0  # replays of every SegmentGraph, a plain count like .launches

    def __init__(self, t: int, widths, monos, valids, states, pcm):
        dev = valids[0].device
        if dev.type != "cuda":
            raise ValueError(f"SegmentGraph needs CUDA tensors, got {dev}")
        t0 = time.perf_counter()
        self.t, self.widths, self.monos = t, tuple(widths), tuple(monos)
        self.valids, self.states, self.pcm = valids, states, pcm
        self.device = dev
        self.bufs = tuple(
            torch.zeros((v.shape[0], v.shape[1], stream_nbytes(t, w, m)),
                        dtype=torch.uint8, device=dev)
            for v, w, m in zip(valids, self.widths, self.monos)
        )

        def body():
            _, new = run_segment_eager(self.bufs, valids, states, t,
                                       self.widths, self.monos, pcm=pcm)
            for st, nw in zip(states, new):
                st.store.copy_(nw.store)
                st.v_fifo.copy_(nw.v_fifo)

        # the warm-up writes fresh outputs: the static state and PCM stay
        self.graph, self.launches = capture(dev, lambda: run_segment_eager(
            self.bufs, valids, states, t, self.widths, self.monos), body)
        # host clock; capture begins with a device synchronisation, so this
        # includes the warm-up's card time
        self.capture_seconds = time.perf_counter() - t0

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        SegmentGraph.replays += 1
        K.add_counts(self.launches)


def capture(dev: torch.device, warm_up, body):
    """warm_up() once, eagerly and on a side stream, then body() captured as
    one CUDA graph, every capture and launch on `dev` whatever the caller's
    current device is. The first launch of a kernel loads its module and
    the wrappers upload the tables: neither may happen while a stream is
    capturing, hence the warm-up. -> (the graph, what one replay launches
    in kernels.all_counts()'s keys); capture records the launches without
    running them, so they are taken off the counts."""
    with torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm_up()
        torch.cuda.current_stream(dev).wait_stream(side)

        before = K.all_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        launches = {k: n - before[k] for k, n in K.all_counts().items()}
        K.add_counts({k: -n for k, n in launches.items()})
    return graph, launches


def static_slots(k: int, t: int, sizes, device):
    """Per-group static buffers for SegmentGraph: (valids int32 [k, S_g],
    zero states, pcm int16 [k, S_g, t*576, 2])."""
    valids = tuple(torch.zeros((k, s), dtype=torch.int32, device=device)
                   for s in sizes)
    states = tuple(init_state(s, device) for s in sizes)
    pcm = tuple(torch.empty((k, s, t * SAMPLES_PER_GR, 2), dtype=torch.int16,
                            device=device) for s in sizes)
    return valids, states, pcm
