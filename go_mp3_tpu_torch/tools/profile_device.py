"""Per-stage card time of the chunk decode (tools/profile_device.py's
counterpart), at the bench's shapes.

    python -m go_mp3_tpu_torch.tools.profile_device [--s 64] [--t 240]
        [--chunks 13] [--device cuda|cpu]

Input: real parsed data, one chunk of T granules of
conformance/synthetic_escape.mp3 x128 through the C++ parser's int8
interface (NativeParser.parse_packed8_into), the same chunk in each of S
streams, the state zero, every granule valid; and its fused wire rows at
the chunk's tail cap. The JAX tool's stage variants map onto the port's
kernels:

  unpack             K4 (kernels.unpack_fused) on the wire
  +requant+stereo    K1 (kernels.requant_stereo) on the int8 arrays, and
                     K1 on the wire (kernels.requant_stereo_fused)
  +aa+imdct+overlap  K1 then K2 (kernels.hybrid)
  full chunk         K5 (kernels.decode_chunk, the chain kernel), and
                     K1 -> K2 -> K3 in sequence (kernels.synth last)
  segment            the scan-amortized cost: a SegmentGraph of --chunks
                     chunks of the wire (one chain launch a chunk), per
                     chunk; its plain row is the eager segment

Each row: card time (CUDA events, the calls queued behind a sleep kernel),
its plain version's card time on the same tensors, and the bound (the
larger of its bytes over the memory rate and its operations over the
float32 rate) with what bounds it. With --device cpu the variants run once
each on the CPU, as a rehearsal, and no time is measured.
"""

from __future__ import annotations

import argparse
import json
from typing import NamedTuple

import numpy as np
import torch

from ..consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
from ..device import resolve_device
from ..native.lib import NativeParser
from ..ops import granule as G
from ..ops import kernels as K
from ..ops.wire import build_fused_chunk, tail_cap_lines
from ..parallel.segment import SegmentGraph, run_segment_eager, static_slots
from .cardtime import bound, chain_flops, device_label, k1_flops, k2_flops, nbytes, time_ms
from .corpus import ESCAPE


class Chunk(NamedTuple):
    """One [S, T] chunk on a device, as each variant reads it."""

    p8: tuple  # tail8 i8 [S,T,1024], head16 i16 [S,T,128], side8 u8 [S,T,168]
    wire: torch.Tensor  # stereo fused rows u8 [S, stream_nbytes(T, lines, False)]
    lines: int  # the wire's tail lines
    state: G.DecodeState
    valid: torch.Tensor  # int32 [S], every granule valid

    @property
    def t(self) -> int:
        return self.p8[0].shape[1]


def parse_chunk(t_dim: int, times: int = 128) -> tuple[np.ndarray, ...]:
    """The first t_dim granules of synthetic_escape.mp3 x `times` through
    the C++ parser's int8 interface -> (tail8 [T,1024], head16 [T,128],
    side8 [T,168])."""
    arrays = (np.zeros((t_dim, SP8_TAIL_WIDTH), np.int8),
              np.zeros((t_dim, HEAD_WIDTH), np.int16),
              np.zeros((t_dim, SIDE8_WIDTH), np.uint8))
    p = NativeParser(ESCAPE.read_bytes() * times)
    try:
        got = 0
        while got < t_dim and (n := p.parse_packed8_into(*(a[got:] for a in arrays))):
            got += n
    finally:
        p.close()
    if got != t_dim:
        raise ValueError(f"parsed {got} granules, wanted {t_dim}")
    return arrays


def make_chunk(s_dim: int, t_dim: int, device) -> Chunk:
    """parse_chunk's granules in each of s_dim streams, on `device`."""
    arrays = tuple(np.broadcast_to(a, (s_dim, *a.shape)).copy() for a in parse_chunk(t_dim))
    lines = tail_cap_lines(arrays[0])
    dev = torch.device(device)
    return Chunk(
        p8=tuple(torch.from_numpy(a).to(dev) for a in arrays),
        wire=torch.from_numpy(build_fused_chunk(*arrays, lines)).to(dev),
        lines=lines,
        state=G.init_state(s_dim, dev),
        valid=torch.full((s_dim,), t_dim, dtype=torch.int32, device=dev),
    )


# -- the variants: (the kernels' route, the plain route) on one chunk ---------
# On CPU tensors the kernels' wrappers run the plain versions themselves.


def unpack(c: Chunk):
    return K.unpack_fused(c.wire, c.t, c.lines)


def unpack_plain(c: Chunk):
    return G.unpack_fused_ref(c.wire, c.t, c.lines)


def requant(c: Chunk):
    return K.requant_stereo(c.p8)


def requant_plain(c: Chunk):
    return G.requant_stereo_ref(G.batch_from_packed8(*c.p8))


def requant_wire(c: Chunk):
    return K.requant_stereo_fused(c.wire, c.t, c.lines)


def requant_wire_plain(c: Chunk):
    return G.requant_stereo_fused_ref(c.wire, c.t, c.lines)


def imdct(c: Chunk):
    """K1 then K2 -> (x18, store). x18 is JAX's out18 (the overlap-add)
    with the frequency inversion applied (G._tables(dev).freq_inv)."""
    x, ginfo = K.requant_stereo(c.p8)
    return K.hybrid(x, ginfo, c.state.store, c.valid)


def imdct_plain(c: Chunk):
    x, ginfo = requant_plain(c)
    return G.hybrid_ref(x, ginfo, c.state.store, c.valid)


def full(c: Chunk):
    """K5: the chain kernel -> (pcm, state)."""
    return K.decode_chunk(c.p8, c.state, c.valid)


def full_plain(c: Chunk):
    return G.decode_chunk_ref(G.batch_from_packed8(*c.p8), c.state, c.valid)


def full_k123(c: Chunk):
    """K1 -> K2 -> K3 through their own wrappers -> (pcm, state)."""
    x, ginfo = K.requant_stereo(c.p8)
    x18, store = K.hybrid(x, ginfo, c.state.store, c.valid)
    pcm, fifo = K.synth(x18, ginfo, c.state.v_fifo, c.valid)
    return pcm, G.DecodeState(store, fifo)


def _flat(out) -> tuple:
    return tuple(t for o in out for t in (o if isinstance(o, tuple) else (o,)))


# name -> (kernels' route, plain route, the inputs it reads, its operations)
VARIANTS = {
    "unpack (K4)": (unpack, unpack_plain, lambda c: (c.wire,), lambda s, t: 0.0),
    "+requant+stereo (K1, int8)": (requant, requant_plain, lambda c: c.p8, k1_flops),
    "+requant+stereo (K1, wire)": (requant_wire, requant_wire_plain,
                                   lambda c: (c.wire,), k1_flops),
    "+aa+imdct+overlap (K1 -> K2)": (
        imdct, imdct_plain, lambda c: (*c.p8, c.state.store, c.valid),
        lambda s, t: k1_flops(s, t) + k2_flops(s, t)),
    "full chunk (K5)": (full, full_plain, lambda c: (*c.p8, *c.state, c.valid), chain_flops),
    "full chunk (K1 -> K2 -> K3)": (full_k123, full_plain,
                                    lambda c: (*c.p8, *c.state, c.valid), chain_flops),
}


def segment_inputs(c: Chunk, k: int):
    """k copies of the chunk's wire and valid counts, one lane group:
    run_segment_eager's (bufs, valids, states, t, widths, monos)."""
    return ((c.wire.expand(k, *c.wire.shape).contiguous(),),
            (c.valid.expand(k, *c.valid.shape).contiguous(),),
            (c.state,), c.t, (c.lines,), (False,))


def run_variants(c: Chunk) -> dict:
    """Every variant once through the kernels' route (on CPU tensors: the
    plain versions) -> {name: its outputs}."""
    return {name: fn(c) for name, (fn, _, _, _) in VARIANTS.items()}


def time_variants(c: Chunk, chunks: int) -> list[dict]:
    """Card time of each variant and of a SegmentGraph of `chunks` chunks
    (per chunk), each beside its plain version and its bound. Raises
    unless the chunk is on a CUDA device."""
    dev = c.valid.device
    if dev.type != "cuda":
        raise RuntimeError(f"card time needs a CUDA device, the chunk is on {dev}")
    s_dim, t_dim = c.p8[0].shape[:2]
    rows = []
    for name, (fn, plain, reads, flops) in VARIANTS.items():
        b = bound(nbytes(*reads(c), *_flat(fn(c))), flops(s_dim, t_dim))
        rows.append({"variant": name, "ms": time_ms(lambda fn=fn: fn(c)),
                     "plain_ms": time_ms(lambda plain=plain: plain(c)), **b})
    bufs, valids, states, t, widths, monos = segment_inputs(c, chunks)
    slots = static_slots(chunks, t, [s_dim], dev)
    graph = SegmentGraph(t, widths, monos, *slots)
    graph.bufs[0].copy_(bufs[0])
    slots[0][0].copy_(valids[0])
    seg_bytes = nbytes(*bufs, *valids, *slots[2]) + 2 * nbytes(*c.state)
    b = bound(seg_bytes, chunks * chain_flops(s_dim, t_dim))
    rows.append({
        "variant": f"segment (SegmentGraph, {chunks} chunks), per chunk",
        "ms": time_ms(graph.replay) / chunks,
        "plain_ms": time_ms(lambda: run_segment_eager(
            bufs, valids, states, t, widths, monos)) / chunks,
        **b, "bound_ms": b["bound_ms"] / chunks,
    })
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.tools.profile_device",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--s", type=int, default=64, help="streams (default 64)")
    ap.add_argument("--t", type=int, default=240, help="granules a chunk (default 240)")
    ap.add_argument("--chunks", type=int, default=13,
                    help="chunks of the segment graph (default 13)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda measures; cpu runs each variant once, untimed")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    c = make_chunk(args.s, args.t, dev)
    label = device_label(dev)
    print(f"device: {label}; S={args.s} T={args.t}, tail lines {c.lines}, "
          f"segment of {args.chunks} chunks")
    if dev.type != "cuda":
        for name in run_variants(c):
            print(f"  {name:44s} ran on the CPU; card time not measured")
        return 0
    rows = time_variants(c, args.chunks)
    print("card time, ms (mean of 20 calls queued behind a sleep kernel):")
    for r in rows:
        print(f"  {r['variant']:44s} {r['ms']:9.4f}  plain {r['plain_ms']:9.4f}  "
              f"bound {r['bound_ms']:.4f} ({r['bound_by']})")
    print(json.dumps({"device": label, "s": args.s, "t": args.t,
                      "chunks": args.chunks, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
