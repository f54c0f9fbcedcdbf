"""The bench's corpus program: every chunk of a corpus decoded with the
state carried, each chunk's PCM reduced to per-lane energies on the card.

Counterpart of make_decode in bench.py (:378-429), the program that one
lax.scan runs over the whole corpus: per chunk, unpack_fused(_mono), the
vmapped decode_chunk_packed8_impl with the state carried, and the energy
sum |int32(pcm)| per lane. Here, per chunk and lane group, one launch of the
chain kernel (kernels.decode_chunk_fused: K1 on the wire rows -> K2 -> K3)
into the group's PCM scratch, then one launch of the energy kernel
(kernels.energy) into the chunk's row of energies. The scratch is reused
from chunk to chunk: as in the scan, no PCM is kept, and only the [C, S]
energies (and the final state) come out.

Two forms of the same launch sequence, as in parallel/segment.py:
 - decode_energies: a Python loop, the plain form (on CPU tensors the
   wrappers run their plain versions);
 - CorpusGraph: the loop captured once into a torch.cuda.CUDAGraph over
   static buffers and replayed, the counterpart of the AOT-compiled scan.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from ..ops import kernels as K
from .segment import capture


class Group(NamedTuple):
    """Lanes [lo, hi) of the corpus, contiguous; mono: the mono wire."""

    lo: int
    hi: int
    mono: bool


def decode_energies(chunks, valids, states, energies, groups, t: int, widths,
                    scratch, on_pcm=None):
    """chunks[c][g] u8 [S_g, wire.stream_nbytes(t, widths[c][g], mono)]: the
    wire rows of chunk c and lane group g; valids int32 [C, S]; states[g] a
    DecodeState of S_g streams; energies int32 [C, S], written in place;
    scratch[g] int16 [S_g, t*576, 2], the group's PCM, overwritten chunk by
    chunk -> the states after the chunks. on_pcm(c, g, pcm), if given, sees
    each chunk's PCM before the next chunk overwrites it."""
    states = list(states)
    for c, bufs in enumerate(chunks):
        for g, (grp, buf) in enumerate(zip(groups, bufs)):
            pcm, states[g] = K.decode_chunk_fused(
                buf, states[g], valids[c, grp.lo:grp.hi], t, widths[c][g], grp.mono,
                out=scratch[g])
            K.energy(pcm, out=energies[c, grp.lo:grp.hi])
            if on_pcm is not None:
                on_pcm(c, g, pcm)
    return tuple(states)


class CorpusGraph:
    """decode_energies captured as one CUDA graph.

    Every argument is a static device tensor that the graph reads or
    writes at its address: before a replay the caller copies the run's wire
    rows into `chunks` and its valid counts into `valids`, and sets
    `states` (e.g. to zero); the replay writes `energies`, and its last
    nodes copy the final state into `states`, so that another graph over
    the same states carries on from it. Each replay adds the launches
    captured to the wrappers' counts (kernels.all_counts())."""

    def __init__(self, chunks, valids, states, energies, groups, t: int, widths, scratch):
        dev = valids.device
        if dev.type != "cuda":
            raise ValueError(f"CorpusGraph needs CUDA tensors, got {dev}")
        t0 = time.perf_counter()
        self.device = dev
        args = (chunks, valids, states, energies, groups, t, widths, scratch)

        def body():
            for st, new in zip(states, decode_energies(*args)):
                st.store.copy_(new.store)
                st.v_fifo.copy_(new.v_fifo)

        # the warm-up leaves the static states as they are (the chain
        # returns new state tensors)
        self.graph, self.launches = capture(dev, lambda: decode_energies(*args), body)
        # host clock, the warm-up's card time included
        self.capture_seconds = time.perf_counter() - t0

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        K.add_counts(self.launches)
