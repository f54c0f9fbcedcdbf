#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (go_mp3_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from go_mp3_tpu_torch/csrc (one nvcc per
source, side by side), then runs these phases and exits non-zero at the
first that fails:

 1. device: the card (nvidia-smi name and power limit), the kernel build,
    the C++ parser build;
 2. kernels against plain: K1, K2 and K3 each against its plain PyTorch
    version on the same seeded synthetic batch (S=64 streams x T=240
    granules, every block class, stereo mode and band variant, ragged valid
    counts including 0), within stated bounds, and timed against it; K1 on
    each of its four inputs (int8, int16, GranuleBatch, the fused wire),
    all four bit-identical on the same granules at every tile size (granules
    a block) the kernel takes, each tile timed, at S=64 x T=240 and the
    Decoder's S=1 x T=128 (and S=5 x T=37, where the GranuleBatch's bool
    fields also sit at an odd address); K4 (the fused-wire unpack, the
    public unpack_fused, one tile size) equal to its plain version and to
    the arrays the wire was built from, timed at S=64 x T=240 and
    S=1 x T=128, and K1's wire route within bounds of
    its plain version and bit-identical to K4 -> K1, stereo and mono, full
    and capped width, and at an odd T and odd width; then K2 and K3 where
    tile edges matter (S=64 at T=240 and T=37, S=1 at T=128 and T=1; valid
    counts of 0, T, and 13-15, at the start of and inside a run), each
    within the same bounds and bit-identical over every run length
    (granules a warp or block) the kernels take, and each run length timed
    at S=64, T=240; the chain kernel (K5: K1 -> K2 -> K3 in one launch,
    which decode_chunk and decode_chunk_fused launch; a block walks a
    segment of L runs of G granules) on each of K1's four inputs,
    bit-identical to K1 -> K2 -> K3 at the wrapper's (G, L) and at every G
    with L = 1, 2, 3 and one segment a stream (S=64 at T=240 and 37, S=1
    at T=128 and 1, a mono wire at S=5 T=37; valid 0, T, 13-15), within
    bounds of its plain version; its shared memory a block and blocks an
    SM printed; at S=64 T=240 and 37, S=1 T=128 and 1 every (G, L) of a
    sweep bit for bit against K1 -> K2 -> K3 and timed, each input at the
    wrapper's pick timed beside K1 + K2 + K3 (the pick five times at
    [64, 240] and [1, 128], for its spread); at T=240 and S = 16, 48, 96,
    192 and 300 (the [64, 240] chunk's streams repeated) the wrapper's
    pick against one run a block and the other segment lengths, each
    bit-identical to one run a block and timed; a chunk of T=0
    through K1 (every input and tile), K2, K3 (every run length), the
    chain (every input and run length), K4, decode_chunk and
    decode_chunk_fused: empty outputs, and the state returned equal to the
    state given; the bench's energy kernel (csrc/energy.cu) bit for bit
    against its plain version at S=64 T=240 and S=1 T=128 (sums that wrap
    past 2^31, -32768 included), into a fresh output and into a row of a
    [C, S] tensor, timed beside the plain version and the torch expression
    of bench.py's reduction;
 3. chunk invariance: the same granules decoded as one chunk and split at
    other boundaries, state carried: bit-identical PCM and state; and a
    k = 4 segment of both lane groups replayed twice through the captured
    SegmentGraph against run_segment_eager: bit-identical PCM and state,
    one chain launch captured per chunk and group;
 4. Decoder: a 94 s stream (conformance/synthetic_escape.mp3 x300) read
    whole and after a seek, against the exact C++ backend, ISO full
    compliance (RMS < 0.289 LSB, max diff <= 2), and a checkpoint/resume;
    the PCM's SHA-256, beside the parent commit's (PARENT; a difference
    fails);
 4b. the Decoder's other sources, on the same stream: the pure-Python
    parse path (use_native=False: StreamDecoder, K1's GranuleBatch route)
    and the streaming parser over a non-seekable reader, both
    byte-identical to phase 4's read; a GaplessDecoder read, byte-identical
    to phase 4's read past the decoder delay;
 5. corpus: decode_corpus_fast over 64 rotated lanes (48 stereo lanes of
    escape x128, 16 mono lanes of lowrate x110: 193,216 granules, ~52 min
    of audio): the defaults (fused wire, mono split; cold and warm),
    fused=False, n_threads=8 alone, bench.py's production settings
    (chunk_t=240, tail_buckets=(464, 512), n_threads=8, drain=4:
    SegmentGraph replays; cold and warm) and fetch=False. All give the
    same bytes, every lane ISO fully compliant against the exact backend
    (the SHA-256 of the lanes' PCM joined in order is printed beside the
    parent commit's; a difference fails);
    each run prints its phase split, widths, wire bytes, graph replays,
    peak device memory, device allocations and the launches of every
    kernel (the fused path launches K1 on the wire, and K4 never);
 5c. the public unpack_fused (K4) on the corpus's own first chunk of
    wire rows, one per lane group, equal to the parser's arrays;
 5b. decode_corpus, the pure-Python parse path of a corpus: the same 64
    lanes cut to their first 768 granules (the Python parse and the
    per-granule staging are host-bound), parsed by parse_stream_granules
    and decoded in chunks of 128 through K1's GranuleBatch route;
    byte-identical to decode_corpus_fast(fused=False) on the same cut
    lanes, every lane ISO full against the exact backend;
 6. the stream mesh (parallel/mesh.py), over every visible card and over
    two entries of cuda:0 (a one-card machine's only split): the sharded
    decoders on the phase-2 batch bit-identical to decode_chunk;
    decode_corpus_fast(mesh=...) with the defaults, the bench settings and
    fetch=False byte-identical to phase 5; decode_corpus with a sharded
    decode_fn byte-identical to phase 5b; torch.cuda.current_device()
    unchanged after every run; walls, lanes per entry, phase split, graph
    replays and launches printed;
 7. the conformance bundle on the card (python -m
    go_mp3_tpu_torch.conformance --device cuda, in this process): exact,
    golden and the card's PCM pairwise ISO full on the bundle's files, the
    corpus settings unsharded and on a two-entry mesh byte-identical to
    the per-stream decodes;
 8. the port's tools on the card (go_mp3_tpu_torch/tools/, through their
    entry points): compliance on both conformance/synthetic_*.mp3 (the
    device backend against exact: FULL COMPLIANCE at offset 0);
    bench_single on its small fixture, exact and device, one rep (the
    device row names the card; its PCM bytes equal exact's);
    profile_device at S=64 T=240 with a 4-chunk segment, each variant
    beside phase 2's time for the same kernels; profile_decode (the host
    parse profile and torch.profiler traces of three windows: one chunk, a
    defaults corpus run and a drain=4 corpus run, each with as many
    chain-kernel events in the trace as chain launches counted; busy
    share, top kernels and idle gaps printed; full output and traces in
    build/traces/); example, whose WAV data equals phase 4's PCM;
 9. the bench (python -m go_mp3_tpu_torch.bench, through its main, in this
    process) on the smoke corpus, every schedule run twice: its JSON line
    names the card; the energies of every full (chunk, lane) equal the
    energies of the same granules of phase 5's PCM bit for bit, and the
    SHA-256 of all its energies equals the parent commit's; it launched
    the chain kernel on the wire and the energy kernel alone;
then the kernels line and the last line: {"ok": true, "device": {...}}.

Each phase of the main path (4 to 9) starts each run with the launch
counts at 0 and checks that the chain kernel ran with K1 on the expected
route (int16 for the Decoder, the GranuleBatch in 4b's Python parse and
5b, the int8 interface for fused=False, the wire on the fused corpus
path and in the bench; with drain, the graph), and that K1-K4 did not (in
5c K4, the public unpack_fused, alone); the JSON line sums the launches
over them (phase 8's profile_device times kernels as phase 2 does: not
counted).
The line before the last is a JSON object with one entry per kernel: its
launches on the main path, its error against the plain version, its card
time and the plain version's (phase 2's shapes), and its bound: the larger
of its bytes over the card's memory rate and its operations over its
float32 rate, computed from this run's inputs (the timer, the bound
arithmetic and the corpus lanes are go_mp3_tpu_torch/tools/cardtime.py's
and corpus.py's, which the tools share). The script imports torch,
the port (go_mp3_tpu_torch, whose `reference` module gives the exact C++
backend and the ISO measure) and the seeded-granule helper
tests/torch_synthetic.py; never jax, and no module of the JAX package
(checked at the end).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
try:  # the measuring code the smoke shares with the port's tools
    from go_mp3_tpu_torch.tools.cardtime import (
        INT32_OPS,
        bound,
        card_identity,
        chain_flops,
        k1_flops,
        k2_flops,
        k3_flops,
        nbytes,
        time_ms,
    )
    from go_mp3_tpu_torch.tools.corpus import N_MONO, N_STEREO, corpus_lanes
except ImportError:  # no torch, or not a checkout: main() says which and exits 2
    pass

SEED = 2026
S_SMOKE, T_SMOKE = 64, 240

KERNEL_ROWS = {  # name -> (source, TPU-side program it replaces)
    "requant_stereo": ("go_mp3_tpu_torch/csrc/requant_stereo.cu",
                       "go_mp3_tpu/ops/granule.py:242"),
    "hybrid": ("go_mp3_tpu_torch/csrc/hybrid.cu",
               "go_mp3_tpu/ops/granule.py:361"),
    "synth": ("go_mp3_tpu_torch/csrc/synth.cu",
              "go_mp3_tpu/ops/granule.py:423"),
    "unpack_fused": ("go_mp3_tpu_torch/csrc/unpack_fused.cu",
                     "go_mp3_tpu/ops/granule.py:661"),
    "chain": ("go_mp3_tpu_torch/csrc/chain.cu",
              "go_mp3_tpu/ops/granule.py:493"),
    "energy": ("go_mp3_tpu_torch/csrc/energy.cu", "bench.py:416"),
}
GRAPH_ROW = ("go_mp3_tpu_torch/parallel/segment.py",
             "go_mp3_tpu/ops/granule.py:726")
SAMPLES_PER_GR_BYTES = 576 * 4  # PCM bytes of one granule


# What the main path gave before the chain kernel walked segments (the
# parent commit's smoke, on an NVIDIA H100 80GB HBM3): no (G, L) may
# change a bit of it.
PARENT = {
    "phase 4 PCM sha256": "a6732bc6d3abb31056676f6ce2ab2aa8a6655ccd5015c9cea7ef8c38f352e011",
    "phase 5 PCM sha256": "b39ad4d61ea96bd35ce4a6cf412da03cc7f368641bd0b65bc56d7e39028febeb",
    "phase 9 energies sha256": "0d173d2db141b825108bac9c9f0fac53126e4848cb4ba7c5b3d78d717d557a0d",
}


def check_parent(what: str, got: str) -> None:
    """Print `got` beside the parent's value of `what`; fail where they differ."""
    want = PARENT[what]
    say(f"{what}: {got} (parent {want}: {'equal' if got == want else 'DIFFERENT'})")
    check(got == want, f"{what} differs from the parent's")


def say(msg: str) -> None:
    print(msg, flush=True)


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device() -> None:
    import torch

    from go_mp3_tpu_torch import reference
    from go_mp3_tpu_torch.ops import _build

    say(card_identity())
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load()
    log = _build.library_path().parent / "build.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    for ln in ptxas:
        say(f"  ptxas: {ln}")
    say(f"phase 1 kernel build: {_build.build_seconds:.2f} s nvcc "
        f"({time.perf_counter() - t0:.2f} s load)")
    t0 = time.perf_counter()
    check(reference.native_available(), "the C++ parser (libmp3parse.so) did not build")
    say(f"phase 1 C++ parser build and load: {time.perf_counter() - t0:.2f} s")


def smoke_batch(s_dim: int, t_dim: int, dev):
    """Seeded synthetic chunk on `dev`: both packed interfaces, a ragged
    valid vector (lane 0 empty, lane 1 full), a non-zero state."""
    import torch

    import torch_synthetic as syn
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    rng = np.random.default_rng(SEED)
    valid = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
    valid[0], valid[1 % s_dim] = 0, t_dim
    sp, sd = syn.random_chunk(SEED, s_dim, t_dim, valid)
    p16 = tuple(torch.from_numpy(a).to(dev) for a in (sp, sd))
    p8 = tuple(torch.from_numpy(a).to(dev) for a in syn.to_packed8(sp, sd))
    state = state_from_numpy(
        (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((s_dim, 2, 16, 64)) * 0.05).astype(np.float32),
        dev,
    )
    return p16, p8, torch.from_numpy(valid).to(dev), state, valid


def _rel(err, scale) -> float:
    """max of err / scale, entry by entry; where the scale is 0 the error
    must be 0."""
    check(bool((err[scale == 0] == 0).all()), "nonzero error on a zero input")
    return float((err / scale.clamp_min(1e-30)).max())


def _rel_per_granule(got, ref) -> float:
    """max |got - ref| over each granule / that granule's max |ref|."""
    return _rel((got - ref).abs().flatten(2).amax(-1), ref.abs().flatten(2).amax(-1))


def synthesis_input(seed: int, shape, dev):
    """x18 at synthesis scale, ~N(0, 0.3^2), as test_stage_parity feeds its
    polyphase check."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.3).astype(np.float32)).to(dev)


def _check_k2(x, ginfo, store, valid, what: str):
    """K2 against hybrid_ref: 2e-6 (the IMDCT bound of test_stage_parity)
    of the scale of what each output sums, per (stream, granule, channel):
    that granule's lines and the previous granule's (the incoming store at
    t = 0). The new store is the upper half of granule valid-1, or the old
    store if valid is 0. -> (x18 error, store error, max abs error, the
    plain x18)."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K

    s_dim = x.shape[0]
    k_x18, k_store = K.hybrid(x, ginfo, store, valid)
    ref_x18, ref_store = G.hybrid_ref(x, ginfo, store, valid)
    cur = x.abs().amax(-1)  # [S, T, 2]
    old = store.abs().flatten(2).amax(-1)  # [S, 2]
    scale = torch.maximum(cur, torch.cat([old[:, None], cur[:, :-1]], 1))
    e_x18 = _rel((k_x18 - ref_x18).abs().flatten(3).amax(-1), scale)
    last = cur[torch.arange(s_dim, device=x.device), (valid.long() - 1).clamp_min(0)]
    st_scale = torch.where((valid > 0)[:, None], last, old)
    e_st = _rel((k_store - ref_store).abs().flatten(2).amax(-1), st_scale)
    check(e_x18 <= 2e-6 and e_st <= 2e-6,
          f"{what}: K2 bound (x18 {e_x18:.3e}, store {e_st:.3e})")
    return e_x18, e_st, float((k_x18 - ref_x18).abs().max()), ref_x18


def _check_k3(x18, ginfo, fifo, valid, what: str) -> tuple[int, float]:
    """K3 against synth_ref: PCM within 1 LSB, the new FIFO within 1e-6 of
    its scale. -> (PCM max diff, FIFO error)."""
    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K

    k_pcm, k_fifo = K.synth(x18, ginfo, fifo, valid)
    ref_pcm, ref_fifo = G.synth_ref(x18, ginfo, fifo, valid)
    d_pcm = int((k_pcm.int() - ref_pcm.int()).abs().max())
    e_fifo = float((k_fifo - ref_fifo).abs().max() / ref_fifo.abs().max().clamp_min(1e-30))
    check(d_pcm <= 1 and e_fifo <= 1e-6,
          f"{what}: K3 bound (PCM {d_pcm} LSB, FIFO {e_fifo:.3e})")
    return d_pcm, e_fifo


MID_RUN_VALID = (13, 14, 15)
TILE_CASES = (  # (S, T, the valid vectors: None = ragged with 0, T and MID_RUN_VALID)
    (64, 240, None),
    (64, 37, None),
    (1, 128, ([0], [128], *([v] for v in MID_RUN_VALID))),
    (1, 1, ([0], [1])),
)
K2_RUNS, K3_RUNS = (1, 2, 3, 4, 8), (1, 2, 3, 4)  # granules per warp / block


def phase_tiles(dev) -> None:
    """K2 and K3 where tile edges matter: a chunk of 64 streams at T = 240
    and at T = 37 (not a multiple of any run length), one stream at T = 128
    and T = 1; valid counts of 0, T, 13, 14 and 15. The last three put
    granule valid-1, whose run writes the new state, at the start of a run
    of up to 4 (12), past the start of a run of 2 to 8 (13), and inside a
    run of 3, 4 or 8 (13) or of 4 or 8 (14), with granules after it in the
    run. Each against its plain version within phase 2's bounds, and the
    wrapper's choice of run length bit-identical to every other (launched
    through the wrappers' private launchers)."""
    import torch

    import torch_synthetic as syn
    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    for i, (s_dim, t_dim, valids) in enumerate(TILE_CASES):
        seed = SEED + 30 + i
        rng = np.random.default_rng(seed)
        full = np.full(s_dim, t_dim, np.int32)  # every row holds a granule
        sp, sd = syn.random_chunk(seed, s_dim, t_dim, full)
        x, ginfo = G.requant_stereo_ref(G.batch_from_any(
            tuple(torch.from_numpy(a).to(dev) for a in (sp, sd))))
        state = state_from_numpy(
            (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), dev)
        x18 = synthesis_input(seed, (s_dim, t_dim, 2, 32, 18), dev)
        if valids is None:
            v = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
            v[0], v[1] = 0, t_dim
            v[2:2 + len(MID_RUN_VALID)] = np.minimum(MID_RUN_VALID, t_dim)
            valids = (v,)
        worst = [0.0, 0.0, 0]
        for v in valids:
            valid = torch.tensor(v, dtype=torch.int32, device=dev)
            what = f"phase 2 tiles S={s_dim} T={t_dim} valid={list(v)[:3]}"
            e_x18, e_st, _, _ = _check_k2(x, ginfo, state.store, valid, what)
            d_pcm, _ = _check_k3(x18, ginfo, state.v_fifo, valid, what)
            worst = [max(worst[0], e_x18), max(worst[1], e_st), max(worst[2], d_pcm)]
            k2 = K.hybrid(x, ginfo, state.store, valid)
            for g in K2_RUNS:
                got = K._hybrid_launch(x, ginfo, state.store, valid, g)
                check(all(torch.equal(a, b) for a, b in zip(got, k2)),
                      f"{what}: K2 with {g} granules a warp differs")
            k3 = K.synth(x18, ginfo, state.v_fifo, valid)
            for g in K3_RUNS:
                got = K._synth_launch(x18, ginfo, state.v_fifo, valid, None, g)
                check(all(torch.equal(a, b) for a, b in zip(got, k3)),
                      f"{what}: K3 with {g} granules a block differs")
        say(f"phase 2 tiles S={s_dim} T={t_dim}, valid "
            f"{'0, T, 13-15 and ragged' if len(valids) == 1 else [int(v[0]) for v in valids]}: "
            f"K2 x18 {worst[0]:.3e}, store {worst[1]:.3e} (<= 2e-6), K3 PCM "
            f"{worst[2]} LSB (<= 1); bit-identical over K2 runs of {K2_RUNS} and "
            f"K3 runs of {K3_RUNS} granules")


WIRE_LINES = 512  # the tail width of phase 2's wire rows


def k1(packed, t_dim: int, stereo: bool = True, tail_lines: int = WIRE_LINES,
       mono: bool = False):
    """K1's wrapper on any of its four inputs: a tuple of arrays or a
    GranuleBatch, or a tensor of wire rows."""
    from go_mp3_tpu_torch.ops import kernels as K

    if isinstance(packed, tuple):
        return K.requant_stereo(packed, stereo)
    return K.requant_stereo_fused(packed, t_dim, tail_lines, mono, stereo)


def k1_batch(packed, t_dim: int, tail_lines: int = WIRE_LINES, mono: bool = False):
    """The GranuleBatch that K1's plain version reads for `packed`."""
    from go_mp3_tpu_torch.ops import granule as G

    if isinstance(packed, tuple):
        return G.batch_from_any(packed)
    unpack = G.unpack_fused_mono_ref if mono else G.unpack_fused_ref
    return G.batch_from_packed8(*unpack(packed, t_dim, tail_lines))


def k1_ref(packed, t_dim: int, stereo: bool = True, **wire_args):
    from go_mp3_tpu_torch.ops import granule as G

    return G.requant_stereo_ref(k1_batch(packed, t_dim, **wire_args), stereo)


K1_CASES = (  # (S, T, wire tail lines, mono): one chunk, K1's four inputs
    (64, 240, 512, False),
    (1, 128, 512, False),
    (5, 37, 301, True),
)


def k1_inputs(seed: int, s_dim: int, t_dim: int, lines: int, mono: bool, dev):
    """One seeded chunk as each of K1's four inputs, all holding the same
    granules: the int8 arrays (wire_chunk's: tail past `lines` zero and,
    mono, channel 1 zero), the int16 interface and the GranuleBatch unpacked
    from them, and the fused rows built from them."""
    import torch

    import torch_synthetic as syn
    from go_mp3_tpu_torch.ops import granule as G

    buf, arrays, _ = wire_chunk(seed, s_dim, t_dim, lines, mono)
    p8 = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    p16 = tuple(torch.from_numpy(a).to(dev) for a in syn.from_packed8(*arrays))
    batch = G.GranuleBatch(*(f.contiguous() for f in G.batch_from_packed(*p16)))
    return {"int8": p8, "int16": p16, "granule_batch": batch,
            "fused": torch.from_numpy(buf).to(dev)}


def _k1_launch(label: str, packed, s_dim, t_dim, stereo, g, lines, mono):
    """K1 through its private launcher, `g` granules a block."""
    from go_mp3_tpu_torch.ops import kernels as K

    if label == "fused":
        return K._requant_stereo_launch(K._FUSED, (packed,), s_dim, t_dim, stereo,
                                        g, lines, mono)
    return K._requant_stereo_launch(*K._k1_inputs(packed), stereo, g)


def _at_odd_address(t):
    """A contiguous copy of `t` one element past an allocation's start
    (an odd address for a 1-byte dtype)."""
    import torch

    out = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def phase_k1_routes(dev) -> dict:
    """K1's four inputs on the same granules (K1_CASES), requantized alone
    and whole: every input at every tile size the kernel takes
    bit-identical to the int8 input through the wrapper. Each input timed
    at each tile at S=64 x T=240 and at the Decoder's S=1 x T=128. ->
    {input: {shape: the wrapper's tile, its time, every tile's, the
    bound}}."""
    import torch

    from go_mp3_tpu_torch.ops import kernels as K

    from go_mp3_tpu_torch.ops import granule as G

    times = {}
    for i, (s_dim, t_dim, lines, mono) in enumerate(K1_CASES):
        inputs = k1_inputs(SEED + 40 + i, s_dim, t_dim, lines, mono, dev)
        odd = s_dim * t_dim % 4
        if odd:  # the bool fields at an odd address, none of whole words
            inputs["granule_batch, flags unaligned"] = G.GranuleBatch(*(
                _at_odd_address(f) if f.dtype == torch.bool else f
                for f in inputs["granule_batch"]))
        for stereo in (False, True):
            want = K.requant_stereo(inputs["int8"], stereo)
            for label, packed in inputs.items():
                for g in K.K1_TILES:
                    got = _k1_launch(label, packed, s_dim, t_dim, stereo, g, lines, mono)
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"K1 [{label}] S={s_dim} T={t_dim} L={lines} mono={mono} "
                          f"stereo={stereo}: {g} granules a block differs from int8")
        say(f"phase 2 K1 routes S={s_dim} T={t_dim} L={lines} mono={mono}: "
            f"{', '.join(inputs)} bit-identical, requantized alone and "
            f"whole, at every tile {K.K1_TILES}")
        if t_dim not in (240, 128):
            continue
        out = nbytes(*want)
        for label, packed in inputs.items():
            tiles = {g: time_ms(lambda packed=packed, g=g: _k1_launch(
                label, packed, s_dim, t_dim, True, g, lines, mono)) for g in K.K1_TILES}
            ins = packed if isinstance(packed, tuple) else (packed,)
            pick = K.k1_tile(dev, s_dim, t_dim)
            times.setdefault(label, {})[f"S={s_dim} T={t_dim}"] = {
                "ms": tiles[pick], "tile": pick, "tiles_ms": tiles,
                **bound(nbytes(*ins) + out, k1_flops(s_dim, t_dim))}
            say(f"phase 2 K1 tiles [{label}] (S={s_dim} T={t_dim}; card time, ms; "
                f"the wrapper's G={pick}): "
                + ", ".join(f"G={g} {t:.4f}" for g, t in tiles.items()))
    return times


CHAIN_CASES = (  # (S, T, wire tail lines, mono, valid vectors as in TILE_CASES)
    (64, 240, 512, False, None),
    (64, 37, 464, False, None),
    (1, 128, 512, False, ([0], [128], *([v] for v in MID_RUN_VALID))),
    (1, 1, 512, False, ([0], [1])),
    (5, 37, 301, True, None),
)
# the chain against its plain version: PCM as K3 on the chain's own x18
# (test_synth_parity's white-noise bounds), the state within the
# requantize bound (2e-5) of its scale
CHAIN_PCM_RMS, CHAIN_PCM_MAX, CHAIN_STATE_REL = 0.289, 72, 2e-5


def k123(packed, t_dim: int, state, valid, lines: int = WIRE_LINES, mono: bool = False):
    """K1 -> K2 -> K3 through their own wrappers: what decode_chunk
    launched before the chain kernel. -> (pcm, store, v_fifo)."""
    from go_mp3_tpu_torch.ops import kernels as K

    x, ginfo = k1(packed, t_dim, tail_lines=lines, mono=mono)
    x18, store = K.hybrid(x, ginfo, state.store, valid)
    pcm, fifo = K.synth(x18, ginfo, state.v_fifo, valid)
    return pcm, store, fifo


def _chain_launch(label: str, packed, s_dim, t_dim, state, valid, g, runs, lines, mono):
    """The chain kernel through its private launcher: a block per segment of
    `runs` runs of `g` granules."""
    from go_mp3_tpu_torch.ops import kernels as K

    if label == "fused":
        layout, tensors = K._FUSED, (packed,)
    else:
        layout, tensors, _, _ = K._k1_inputs(packed)
    pcm, st = K._chain_launch(layout, tensors, s_dim, t_dim, state, valid, None, g, runs,
                              lines, mono)
    return pcm, st.store, st.v_fifo


def chain_segments(t_dim: int) -> list[tuple[int, int]]:
    """(G, L) pairs that cover the chain kernel's segment edges at T: every
    G with L = 1, 2, 3 and one segment a stream."""
    from go_mp3_tpu_torch.ops import kernels as K

    return sorted({(g, min(n, -(-t_dim // g))) for g in K.CHAIN_RUNS
                   for n in (1, 2, 3, -(-t_dim // g))})


# the segment lengths timed at each G (those above T's runs dropped; one
# segment a stream added)
CHAIN_SWEEP_L = (1, 2, 3, 4, 5, 6, 8, 10, 12, 15, 20, 30, 60)
CHAIN_TIMED = ((64, 240), (64, 37), (1, 128), (1, 1))  # (S, T) timed at every (G, L)
CHAIN_SPREAD = 5  # timings of the wrapper's pick, for its spread
# streams timed at T = 240 for the wrapper's pick: the bench's lane groups
# (16 mono, 48 stereo, and 32 and 96, 64 and 192 at 2x and 4x its lanes) and
# more streams than an H100 has block slots (264)
CHAIN_PICK_S = (16, 48, 96, 192, 300)


def chain_sweep(t_dim: int) -> list[tuple[int, int]]:
    """Every (G, L) the smoke times at T: each G at CHAIN_SWEEP_L and one
    segment a stream."""
    from go_mp3_tpu_torch.ops import kernels as K

    out = set()
    for g in K.CHAIN_RUNS:
        runs = -(-t_dim // g)
        out |= {(g, n) for n in CHAIN_SWEEP_L if n <= runs} | {(g, runs)}
    return sorted(out)


def chain_occupancy(dev) -> dict:
    """The chain kernel's shared memory a block and blocks an SM, by input,
    G and L (1, or a walk), printed. -> {"<input> G=<g> L<..>": [bytes, blocks]}"""
    from go_mp3_tpu_torch.ops import kernels as K

    occ = {}
    for label, layout in (("int8", K._INT8), ("int16", K._INT16),
                          ("granule_batch", K._BATCH), ("fused", K._FUSED)):
        for g in K.CHAIN_RUNS:
            for n in (1, 2):
                occ[f"{label} G={g} L{'=1' if n == 1 else '>1'}"] = list(
                    K.chain_occupancy(dev, layout, g, n))
    say("phase 2 chain shared memory a block (bytes) and blocks an SM "
        "(cudaOccupancyMaxActiveBlocksPerMultiprocessor): "
        + ", ".join(f"{k} {b} B x{n}" for k, (b, n) in occ.items()))
    return occ


def chain_pick_sweep(dev, p8, state, valid, t_dim: int) -> dict:
    """At T and each S of CHAIN_PICK_S (the int8 chunk's streams, state and
    valid counts repeated): the wrapper's (G, L), one run a block, the
    longest segment whose blocks fit one wave of two an SM, and chain_sweep's
    segment lengths at the pick's G, each bit-identical to one run a block
    and timed. -> {"S=<s>": {"pick": [G, L], "ms": {"G=<g> L=<n>": ms}}}"""
    import torch

    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops.granule import DecodeState

    out = {}
    for s_dim in CHAIN_PICK_S:
        rows = torch.arange(s_dim, device=dev) % p8[0].shape[0]
        ins = tuple(t.index_select(0, rows).contiguous() for t in p8)
        st = DecodeState(*(t.index_select(0, rows).contiguous() for t in state))
        v = valid.index_select(0, rows).contiguous()
        pick = K.chain_run(dev, s_dim, t_dim)
        g, runs = pick[0], -(-t_dim // pick[0])
        one_wave = -(-runs // max(1, min(runs, 2 * K._sm_count(dev) // s_dim)))
        lens = sorted({n for gg, n in chain_sweep(t_dim) if gg == g} | {pick[1], one_wave})
        want = _chain_launch("int8", ins, s_dim, t_dim, st, v, g, 1, 0, False)
        ms = {}
        for n in lens:
            def run(n=n):
                return _chain_launch("int8", ins, s_dim, t_dim, st, v, g, n, 0, False)
            check(all(torch.equal(a, b) for a, b in zip(run(), want)),
                  f"phase 2 chain pick S={s_dim} T={t_dim} G={g} L={n}: differs from L=1")
            ms[f"G={g} L={n}"] = time_ms(run)
        out[f"S={s_dim}"] = {"pick": list(pick), "one_wave_L": one_wave, "ms": ms}
        say(f"phase 2 time chain pick [int8] (S={s_dim} T={t_dim}, the S=64 chunk's streams "
            f"repeated; card time, ms; every L bit-identical to L=1): the wrapper's (G, L)="
            f"{pick} {ms[f'G={g} L={pick[1]}']:.4f}, L=1 {ms[f'G={g} L=1']:.4f}, the longest "
            f"one-wave segment L={one_wave} ({s_dim * -(-runs // one_wave)} blocks) "
            f"{ms[f'G={g} L={one_wave}']:.4f}; "
            + "; ".join(f"{k} {t:.4f}" for k, t in ms.items()))
    return out


def phase_chain(dev) -> dict:
    """The chain kernel (K5) on each of K1's four inputs (CHAIN_CASES:
    [64, 240], [64, 37], the Decoder's [1, 128], [1, 1] and a mono wire [5,
    37]; valid 0, T, 13-15 and ragged): bit for bit against K1 -> K2 -> K3
    at the wrapper's (G, L) and at every G with L = 1, 2, 3 and one segment
    a stream (chain_segments), and within bounds of its plain version
    (decode_chunk_ref). At CHAIN_TIMED, every (G, L) of chain_sweep on the
    int8 input is held bit for bit against K1 -> K2 -> K3 and the
    wrapper's pick, and timed; each input at the pick beside K1 + K2 + K3
    (and K2 and K3 alone at [1, 128]); the pick at [64, 240] and [1, 128]
    CHAIN_SPREAD times; then chain_pick_sweep. -> its row of the kernels
    line."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    row, worst = {"occupancy": chain_occupancy(dev)}, [0.0, 0, 0.0]
    cases = list(CHAIN_CASES) + [(s, t, 512, False, ([t],)) for s, t in CHAIN_TIMED
                                 if not any(c[:2] == (s, t) for c in CHAIN_CASES)]
    for i, (s_dim, t_dim, lines, mono, valids) in enumerate(cases):
        seed = SEED + 60 + i
        rng = np.random.default_rng(seed)
        inputs = k1_inputs(seed, s_dim, t_dim, lines, mono, dev)
        state = state_from_numpy(
            (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), dev)
        if valids is None:
            v = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
            v[0], v[1] = 0, t_dim
            v[2:2 + len(MID_RUN_VALID)] = np.minimum(MID_RUN_VALID, t_dim)
            valids = (v,)
        plain_batch = k1_batch(inputs["fused"], t_dim, lines, mono)
        pick = K.chain_run(dev, s_dim, t_dim)
        for v in valids:
            valid = torch.tensor(v, dtype=torch.int32, device=dev)
            what = f"phase 2 chain S={s_dim} T={t_dim} mono={mono} valid={list(v)[:5]}"
            for label, packed in inputs.items():
                want = k123(packed, t_dim, state, valid, lines, mono)
                pcm, st = K.chain(packed, state, valid, **(
                    {"t": t_dim, "tail_lines": lines, "mono": mono} if label == "fused" else {}))
                check(all(torch.equal(a, b) for a, b in zip((pcm, st.store, st.v_fifo), want)),
                      f"{what} [{label}]: the wrapper's chain {pick} differs from "
                      f"K1 -> K2 -> K3")
                for g, n in chain_segments(t_dim):
                    out = _chain_launch(label, packed, s_dim, t_dim, state, valid, g, n,
                                        lines, mono)
                    check(all(torch.equal(a, b) for a, b in zip(out, want)),
                          f"{what} [{label}]: the chain with G={g} L={n} differs from "
                          f"K1 -> K2 -> K3")
            ref_pcm, ref_st = G.decode_chunk_ref(plain_batch, state, valid)
            d = (pcm.int() - ref_pcm.int()).double()
            rms, mx = float(d.pow(2).mean().sqrt()), int(d.abs().max())
            e_st = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                       for a, b in ((st.store, ref_st.store), (st.v_fifo, ref_st.v_fifo)))
            check(rms < CHAIN_PCM_RMS and mx <= CHAIN_PCM_MAX and e_st <= CHAIN_STATE_REL,
                  f"{what}: chain against plain: PCM RMS {rms:.4f} max {mx}, state "
                  f"{e_st:.3e}")
            worst = [max(worst[0], rms), max(worst[1], mx), max(worst[2], e_st)]
        say(f"phase 2 chain S={s_dim} T={t_dim} L={lines} mono={mono}, valid "
            f"{'0, T, 13-15 and ragged' if len(valids) == 1 and len(valids[0]) > 1 else [int(v[0]) for v in valids]}: "
            f"{', '.join(inputs)} bit-identical to K1 -> K2 -> K3 at the wrapper's (G, L) = "
            f"{pick} and at (G, L) = {chain_segments(t_dim)}")
        if (s_dim, t_dim) not in CHAIN_TIMED:
            continue
        shape = f"S={s_dim} T={t_dim}"
        # the first valid vector: ragged at S = 64; every granule at S = 1
        valid = torch.tensor(valids[0] if s_dim > 1 else [t_dim], dtype=torch.int32,
                             device=dev)
        out = nbytes(pcm, valid) + 2 * nbytes(state.store, state.v_fifo)
        flops = chain_flops(s_dim, t_dim)
        p8 = inputs["int8"]
        want = k123(p8, t_dim, state, valid, lines, mono)
        sweep = {}
        for g, n in chain_sweep(t_dim):
            def run(g=g, n=n):
                return _chain_launch("int8", p8, s_dim, t_dim, state, valid, g, n, lines, mono)
            check(all(torch.equal(a, b) for a, b in zip(run(), want)),
                  f"phase 2 chain sweep {shape} G={g} L={n}: differs from "
                  f"K1 -> K2 -> K3 (and the wrapper's pick)")
            sweep[(g, n)] = time_ms(run)
        say(f"phase 2 time chain sweep [int8] ({shape}; card time, ms; the wrapper's "
            f"(G, L)={pick}; every (G, L) bit-identical to K1 -> K2 -> K3): "
            + "; ".join(f"G={g} L={n} {t:.4f}" for (g, n), t in sweep.items())
            + f"; fastest {min((t, g, n) for (g, n), t in sweep.items())}")
        for label, packed in inputs.items():
            ins = packed if isinstance(packed, tuple) else (packed,)
            ms = time_ms(lambda packed=packed: _chain_launch(
                label, packed, s_dim, t_dim, state, valid, *pick, lines, mono))
            k3_ms = time_ms(lambda packed=packed: k123(packed, t_dim, state, valid, lines, mono))
            row.setdefault("routes", {}).setdefault(label, {})[shape] = {
                "ms": ms, "run": list(pick), "k1_k2_k3_ms": k3_ms,
                **bound(nbytes(*ins) + out, flops)}
            say(f"phase 2 time chain [{label}] ({shape}; card time, ms; the wrapper's "
                f"(G, L)={pick}): {ms:.4f}; K1 -> K2 -> K3 {k3_ms:.4f}")
        entry = row["routes"]["int8"][shape]
        entry["sweep_ms"] = {f"G={g} L={n}": t for (g, n), t in sweep.items()}
        if (s_dim, t_dim) in ((64, 240), (1, 128)):
            reps = [time_ms(lambda: _chain_launch("int8", p8, s_dim, t_dim, state, valid,
                                                  *pick, lines, mono))
                    for _ in range(CHAIN_SPREAD)]
            entry["spread_ms"] = [min(reps), max(reps)]
            say(f"phase 2 time chain [int8] ({shape}; the wrapper's (G, L)={pick}) "
                f"{CHAIN_SPREAD} timings: {', '.join(f'{t:.4f}' for t in reps)} ms")
        if s_dim == 1 and t_dim == 128:
            x, ginfo = K.requant_stereo(inputs["int16"])
            x18, _ = K.hybrid(x, ginfo, state.store, valid)
            row["k2_k3_ms"] = {shape: {
                "hybrid": time_ms(lambda: K.hybrid(x, ginfo, state.store, valid)),
                "synth": time_ms(lambda: K.synth(x18, ginfo, state.v_fifo, valid))}}
            say(f"phase 2 time K2, K3 alone ({shape}; card time, ms): "
                f"{row['k2_k3_ms'][shape]}")
        if (s_dim, t_dim) == (64, 240):
            row["plain_ms"] = time_ms(lambda: G.decode_chunk_ref(plain_batch, state, valid))
            row["pick_sweep"] = chain_pick_sweep(dev, p8, state, valid, t_dim)
    say(f"phase 2 chain against plain (decode_chunk_ref): worst PCM RMS {worst[0]:.4f} "
        f"(< {CHAIN_PCM_RMS}), max {worst[1]} (<= {CHAIN_PCM_MAX}), state "
        f"{worst[2]:.3e} (<= {CHAIN_STATE_REL})")
    routes = row.pop("routes")
    int8 = routes.pop("int8")
    row.update(max_abs_err=float(worst[1]), **int8.pop("S=64 T=240"), shapes=int8,
               routes=routes)
    return row


ENERGY_SHAPES = ((64, 240), (1, 128))  # (S, T): the bench's chunk, the Decoder's


def energy_pcm(seed: int, s_dim: int, t_dim: int, dev):
    """Seeded int16 PCM [S, T*576, 2] over the full range: every lane's sum
    passes 2^31 and wraps; lane 0 is all -32768, and each lane's first
    sample is."""
    import torch

    rng = np.random.default_rng(seed)
    a = rng.integers(-32768, 32768, (s_dim, t_dim * 576, 2)).astype(np.int16)
    a[0] = -32768
    a[:, 0, 0] = -32768
    return torch.from_numpy(a).to(dev)


def phase_energy(dev) -> dict:
    """The energy kernel (csrc/energy.cu, kernels.energy) bit for bit against
    energy_ref at [64, 240] and [1, 128] (the sums wrap; -32768 included),
    into a fresh output and into a row slice of a [C, S] tensor as the
    bench writes it; timed beside energy_ref and the torch expression of
    bench.py's reduction (three calls: int32, abs, an int32 sum). -> its row
    of the kernels line."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K

    row = {}
    for i, (s_dim, t_dim) in enumerate(ENERGY_SHAPES):
        pcm = energy_pcm(SEED + 90 + i, s_dim, t_dim, dev)
        want = G.energy_ref(pcm)
        table = torch.zeros((3, s_dim + 2), dtype=torch.int32, device=dev)
        got = K.energy(pcm)
        K.energy(pcm, out=table[1, 1:s_dim + 1])
        torch.cuda.synchronize()
        check(torch.equal(got, want) and torch.equal(table[1, 1:s_dim + 1], want)
              and not table[0].any() and not table[2].any() and not table[1, 0]
              and not table[1, -1],
              f"phase 2 energy S={s_dim} T={t_dim}: kernel {got[:4].tolist()} against "
              f"energy_ref {want[:4].tolist()}")
        expr = lambda pcm=pcm: pcm.int().abs().sum(dim=(1, 2), dtype=torch.int32)  # noqa: E731
        same = torch.equal(expr(), want)
        unwrapped = pcm.to(torch.int64).abs().sum(dim=(1, 2))
        shape = f"S={s_dim} T={t_dim}"
        row[shape] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda pcm=pcm: K.energy(pcm)),
            "plain_ms": time_ms(lambda pcm=pcm: G.energy_ref(pcm)),
            "torch_expr_ms": time_ms(expr),
            **bound(nbytes(pcm, want), 2.0 * pcm.numel(), INT32_OPS),
        }
        r = row[shape]
        say(f"phase 2 energy {shape}: bit-identical to energy_ref, into a fresh output and "
            f"into a row of a [C, S] tensor ({int((unwrapped >= 2**31).sum())} of {s_dim} "
            f"sums past 2^31, {int(unwrapped.min())}-{int(unwrapped.max())} unwrapped; "
            f"lane 0 all -32768); card time "
            f"{r['ms']:.4f} ms, energy_ref {r['plain_ms']:.4f} ms, torch expression "
            f"(three calls{'' if same else ', NOT equal to energy_ref'}) "
            f"{r['torch_expr_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bound_bytes']} B)")
    first = row.pop(next(iter(row)))  # the bench's chunk, [64, 240]
    return {**first, "shapes": row}


def phase_empty_chunk(dev) -> None:
    """A chunk of T = 0 granules: K1 on each input at every tile, K2 and K3
    at every run length, K4, decode_chunk on each input and
    decode_chunk_fused, stereo and mono: empty outputs of the right shapes,
    no launch, and the state returned equal to the state given."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    s_dim, lines = 3, 301
    rng = np.random.default_rng(SEED + 50)
    state = state_from_numpy(
        (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), dev)
    valid = torch.zeros(s_dim, dtype=torch.int32, device=dev)
    p16 = (torch.zeros((s_dim, 0, 1152), dtype=torch.int16, device=dev),
           torch.zeros((s_dim, 0, 144), dtype=torch.int16, device=dev))
    p8 = (torch.zeros((s_dim, 0, 1024), dtype=torch.int8, device=dev),
          torch.zeros((s_dim, 0, 128), dtype=torch.int16, device=dev),
          torch.zeros((s_dim, 0, 168), dtype=torch.uint8, device=dev))
    batch = G.GranuleBatch(*(torch.zeros((s_dim, 0, *inner), dtype=dtype, device=dev)
                             for dtype, inner in G.BATCH_FIELDS.values()))
    wire = torch.zeros((s_dim, 0), dtype=torch.uint8, device=dev)
    K.reset_launch_counts()

    def same_state(st, what):
        check(torch.equal(st.store, state.store) and torch.equal(st.v_fifo, state.v_fifo),
              f"T=0 {what}: the state returned differs from the state given")

    for label, packed in (("int8", p8), ("int16", p16), ("granule_batch", batch),
                          ("fused", wire)):
        for g in K.K1_TILES:
            x, ginfo = _k1_launch(label, packed, s_dim, 0, True, g, lines, False)
            check(x.shape == (s_dim, 0, 2, 576) and ginfo.shape == (s_dim, 0),
                  f"T=0 K1 [{label}] G={g}: shapes {x.shape}, {ginfo.shape}")
        if label != "fused":
            pcm, st = K.decode_chunk(packed, state, valid)
            check(pcm.shape == (s_dim, 0, 2), f"T=0 decode_chunk [{label}]: {pcm.shape}")
            same_state(st, f"decode_chunk [{label}]")
    for mono in (False, True):
        pcm, st = K.decode_chunk_fused(wire, state, valid, 0, lines, mono)
        check(pcm.shape == (s_dim, 0, 2), f"T=0 decode_chunk_fused: {pcm.shape}")
        same_state(st, f"decode_chunk_fused mono={mono}")
        got = K.unpack_fused(wire, 0, lines, mono)
        check([tuple(a.shape) for a in got] == [(s_dim, 0, 1024), (s_dim, 0, 128),
                                                (s_dim, 0, 168)],
              f"T=0 K4 mono={mono}: shapes {[a.shape for a in got]}")
    x = torch.zeros((s_dim, 0, 2, 576), dtype=torch.float32, device=dev)
    ginfo = torch.zeros((s_dim, 0), dtype=torch.int32, device=dev)
    x18 = torch.zeros((s_dim, 0, 2, 32, 18), dtype=torch.float32, device=dev)
    for g in K2_RUNS:
        got, store = K._hybrid_launch(x, ginfo, state.store, valid, g)
        check(got.shape == x18.shape and torch.equal(store, state.store),
              f"T=0 K2 with {g} granules a warp")
    for g in K3_RUNS:
        pcm, fifo = K._synth_launch(x18, ginfo, state.v_fifo, valid, None, g)
        check(pcm.shape == (s_dim, 0, 2) and torch.equal(fifo, state.v_fifo),
              f"T=0 K3 with {g} granules a block")
    for label, packed in (("int8", p8), ("int16", p16), ("granule_batch", batch),
                          ("fused", wire)):
        for g in K.CHAIN_RUNS:
            for n in (1, 3):
                pcm, store, fifo = _chain_launch(label, packed, s_dim, 0, state, valid, g, n,
                                                 lines, False)
                check(pcm.shape == (s_dim, 0, 2) and torch.equal(store, state.store)
                      and torch.equal(fifo, state.v_fifo), f"T=0 chain [{label}] G={g} L={n}")
    counts = K.all_counts()
    check(not any(counts.values()), f"T=0: a kernel was launched ({counts})")
    say(f"phase 2 tiles S={s_dim} T=0: K1 (4 inputs x tiles {K.K1_TILES}), K2 (runs "
        f"{K2_RUNS}), K3 (runs {K3_RUNS}), K4 (stereo and mono), the chain (4 inputs "
        f"x runs {K.CHAIN_RUNS} x L = 1, 3), decode_chunk (3 inputs) and decode_chunk_fused "
        f"(stereo and mono): empty outputs, no launch, the state returned equal to "
        f"the state given")


def phase_kernels(dev, s_dim: int, t_dim: int) -> dict:
    """K1 (each input), K2, K3 against their plain versions on the same
    inputs; one eager chunk of the fused=False path timed."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops import wire as W

    p16, p8, valid, state, _ = smoke_batch(s_dim, t_dim, dev)
    batch = G.GranuleBatch(*(f.contiguous() for f in G.batch_from_packed(*p16)))
    wire = torch.from_numpy(W.build_fused_chunk(*(a.cpu().numpy() for a in p8))).to(dev)
    rows = {}

    # K1, each of its inputs: requantize alone (2e-5 of the granule's
    # scale, test_stage_parity's bound), then the stereo part on the
    # kernel's own requantized input (1e-6)
    routes = {}
    for label, packed in (("int8", p8), ("int16", p16), ("granule_batch", batch),
                          ("fused", wire)):
        b = k1_batch(packed, t_dim)
        k_req, k_ginfo = k1(packed, t_dim, stereo=False)
        ref_req, ref_ginfo = G.requant_stereo_ref(b, stereo=False)
        check(torch.equal(k_ginfo, ref_ginfo), f"K1 {label}: ginfo differs")
        e_req = _rel_per_granule(k_req, ref_req)
        k_x, _ = k1(packed, t_dim)
        e_st = _rel_per_granule(k_x, G._stereo(b, k_req))
        ref_x, ginfo = G.requant_stereo_ref(b)
        e_all = _rel_per_granule(k_x, ref_x)
        say(f"phase 2 K1 requant_stereo [{label}]: requant rel {e_req:.3e} "
            f"(<= 2e-5), stereo rel {e_st:.3e} (<= 1e-6), whole rel {e_all:.3e}")
        check(e_req <= 2e-5 and e_st <= 1e-6 and e_all <= 2e-5, f"K1 {label} bound")
        ins = packed if isinstance(packed, tuple) else (packed,)
        routes[label] = {
            "max_abs_err": float((k_x - ref_x).abs().max()),
            "ms": time_ms(lambda packed=packed: k1(packed, t_dim)),
            "plain_ms": time_ms(lambda packed=packed: k1_ref(packed, t_dim)),
            **bound(nbytes(*ins, k_x, ref_ginfo), k1_flops(s_dim, t_dim)),
        }
        if label == "int8":
            x, x_ginfo = ref_x, ginfo
    rows["requant_stereo"] = {**routes.pop("int8"), "routes": routes}
    # the GranuleBatch route reads the int16 route's granules field by
    # field: the same bits, requantized alone and whole
    for stereo in (False, True):
        a, b = K.requant_stereo(batch, stereo), K.requant_stereo(p16, stereo)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"K1 GranuleBatch route differs from the int16 route (stereo={stereo})")
    for label, packed in (("int8", p8), ("int16", p16), ("granule_batch", batch),
                          ("fused", wire)):
        say(f"phase 2 K1 requant_stereo [{label}] per call, host included: "
            f"{time_ms(lambda: k1(packed, t_dim), queued=False):.4f} ms "
            f"(card time {time_ms(lambda: k1(packed, t_dim)):.4f} ms)")
    # K5' (the fused=False path's chunk, chunk_t = 256): one eager launch of
    # the chain kernel
    p16e, p8e, valid_e, state_e, _ = smoke_batch(s_dim, 256, dev)
    eager = time_ms(lambda: K.decode_chunk(p8e, state_e, valid_e))
    pcm_e, _ = K.decode_chunk(p8e, state_e, valid_e)
    e_bound = bound(nbytes(*p8e, valid_e, pcm_e) + 2 * nbytes(*state_e),
                    chain_flops(s_dim, 256))
    say(f"phase 2 time decode_chunk (K5', one eager chunk of the fused=False "
        f"path, int8, S={s_dim}, T=256): {eager:.4f} ms, bound "
        f"{e_bound['bound_ms']:.4f} ms ({e_bound['bound_by']})")
    rows["segment_graph_eager_chunk"] = {"ms": eager, **e_bound}

    # K2 against plain (bound: _check_k2)
    ginfo = x_ginfo
    e_x18, e_st, k2_err, ref_x18 = _check_k2(x, ginfo, state.store, valid, "phase 2 K2")
    say(f"phase 2 K2 hybrid: x18 {e_x18:.3e}, store {e_st:.3e} of each "
        f"granule's input scale (<= 2e-6)")
    rows["hybrid"] = {
        "max_abs_err": k2_err,
        "ms": time_ms(lambda: K.hybrid(x, ginfo, state.store, valid)),
        "plain_ms": time_ms(lambda: G.hybrid_ref(x, ginfo, state.store, valid)),
        **bound(nbytes(x, ginfo, state.store, valid, ref_x18, state.store),
                k2_flops(s_dim, t_dim)),
    }

    # K3 on synthesis-scale input (bound: _check_k3)
    x18 = synthesis_input(SEED + 1, ref_x18.shape, dev)
    fifo = state.v_fifo * 6.0
    d_pcm, e_fifo = _check_k3(x18, ginfo, fifo, valid, "phase 2 K3")
    say(f"phase 2 K3 synth: PCM max diff {d_pcm} LSB (<= 1), state rel "
        f"{e_fifo:.3e} (<= 1e-6)")
    # and on the synthetic chain's own x18, up to ~1e4 x full scale, where
    # f32 rounding alone moves samples by several LSB (test_synth_parity's
    # white-noise bounds: RMS < 0.289, max <= 72)
    c_pcm, _ = K.synth(ref_x18, ginfo, state.v_fifo, valid)
    r_pcm, _ = G.synth_ref(ref_x18, ginfo, state.v_fifo, valid)
    dd = (c_pcm.int() - r_pcm.int()).double()
    rms, mx = float(dd.pow(2).mean().sqrt()), int(dd.abs().max())
    say(f"phase 2 K3 synth on chain output: RMS {rms:.4f} LSB (< 0.289), "
        f"max {mx} (<= 72)")
    check(rms < 0.289 and mx <= 72, "K3 chain-output bound")
    pcm_out = torch.empty((s_dim, t_dim * 576, 2), dtype=torch.int16, device=dev)
    rows["synth"] = {
        "max_abs_err": float(d_pcm),
        "ms": time_ms(lambda: K.synth(x18, ginfo, fifo, valid)),
        "plain_ms": time_ms(lambda: G.synth_ref(x18, ginfo, fifo, valid)),
        **bound(nbytes(x18, ginfo, fifo, valid, pcm_out, fifo), k3_flops(s_dim, t_dim)),
    }
    for name in ("requant_stereo", "hybrid", "synth"):
        r = rows[name]
        say(f"phase 2 time {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (S={s_dim}, T={t_dim}; card time)")
    # every run length on the same inputs, through the private launchers
    sms = K._sm_count(dev)
    k2 = [time_ms(lambda g=g: K._hybrid_launch(x, ginfo, state.store, valid, g))
          for g in K2_RUNS]
    k3 = [time_ms(lambda g=g: K._synth_launch(x18, ginfo, fifo, valid, None, g))
          for g in K3_RUNS]
    say(f"phase 2 run lengths (S={s_dim}, T={t_dim}; card time, ms): K2 "
        + ", ".join(f"G={g} {t:.4f}" for g, t in zip(K2_RUNS, k2))
        + f" (wrapper: G={K.run_length(s_dim * 2, t_dim, 2 * sms)}); K3 "
        + ", ".join(f"G={g} {t:.4f}" for g, t in zip(K3_RUNS, k3))
        + f" (wrapper: G={K.run_length(s_dim, t_dim, 2 * sms)})")
    return rows


def phase_chunk_invariance(dev, s_dim: int, t_dim: int) -> None:
    """One chunk vs the same granules split at other boundaries."""
    import torch

    from go_mp3_tpu_torch.ops.granule import DecodeState
    from go_mp3_tpu_torch.ops.kernels import decode_chunk

    _, p8, valid_d, state0, valid = smoke_batch(s_dim, t_dim, dev)
    whole, st_whole = decode_chunk(p8, state0, valid_d)
    splits = (
        (0, t_dim * 2 // 5, t_dim),
        tuple(range(0, t_dim, 64)) + (t_dim,),
        (0, 1, 19, t_dim),
    )
    for bounds in splits:
        st = DecodeState(*state0)
        pieces = []
        for lo, hi in zip(bounds, bounds[1:]):
            v = np.clip(valid - lo, 0, hi - lo).astype(np.int32)
            part = tuple(a[:, lo:hi].contiguous() for a in p8)
            pcm, st = decode_chunk(part, st, torch.from_numpy(v).to(dev))
            pieces.append((pcm, v))
        for s in range(s_dim):
            got = torch.cat([p[s, : v[s] * 576] for p, v in pieces])
            check(torch.equal(got, whole[s, : valid[s] * 576]),
                  f"chunk split {bounds}: PCM of stream {s} differs")
        check(torch.equal(st.store, st_whole.store)
              and torch.equal(st.v_fifo, st_whole.v_fifo),
              f"chunk split {bounds}: state differs")
    say(f"phase 3 chunk invariance: splits {splits} give bit-identical PCM "
        f"and state ({int(valid.sum())} granules)")


def wire_chunk(seed: int, s_dim: int, t_dim: int, lines: int, mono: bool):
    """Seeded synthetic granules as fused rows (numpy u8 [S, n]) and the
    int8-interface arrays they carry: tail lines past `lines` zero, and
    channel 1 zero on mono rows (the wire's contract)."""
    import torch_synthetic as syn
    from go_mp3_tpu_torch.ops import wire as W

    rng = np.random.default_rng(seed)
    valid = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
    sp, sd = syn.random_chunk(seed, s_dim, t_dim, valid)
    tail, head, side = syn.to_packed8(sp, sd)
    tail = tail.reshape(s_dim, t_dim, 2, 512).copy()
    tail[..., lines:] = 0
    head = head.reshape(s_dim, t_dim, 2, 64).copy()
    if mono:
        tail[:, :, 1] = 0
        head[:, :, 1] = 0
    arrays = (tail.reshape(s_dim, t_dim, 1024), head.reshape(s_dim, t_dim, 128), side)
    build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
    return build(*arrays, lines), arrays, valid


def phase_unpack(dev, s_dim: int, t_dim: int) -> dict:
    """K4 against its plain version: exact equality, and both
    equal to the arrays the wire was built from. K1's wire route on the
    same rows: within phase 2's bounds of its plain version, and
    bit-identical to K1 on K4's arrays (requantized alone and whole)."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K

    cases = [  # (label, lanes, T, width, mono); each case its own data
        ("stereo", s_dim, t_dim, 512, False),
        ("stereo group", N_STEREO, t_dim, 512, False),
        ("stereo group capped", N_STEREO, t_dim, 464, False),
        ("mono group", N_MONO, t_dim, 512, True),
        ("mono group capped", N_MONO, t_dim, 301, True),
        ("stereo odd", 5, 37, 301, False),
        ("mono odd", 5, 37, 301, True),
    ]
    for i, (label, s, t, lines, mono) in enumerate(cases):
        buf_np, arrays, _ = wire_chunk(SEED + 10 + i, s, t, lines, mono)
        buf = torch.from_numpy(buf_np).to(dev)
        got = K.unpack_fused(buf, t, lines, mono)
        ref = (G.unpack_fused_mono_ref if mono else G.unpack_fused_ref)(buf, t, lines)
        for name, a, b, want in zip(("tail8", "head16", "side8"), got, ref, arrays):
            check(torch.equal(a, b), f"K4 {label}: {name} differs from plain")
            check(np.array_equal(a.cpu().numpy(), want),
                  f"K4 {label}: {name} differs from the wire's source arrays")
        worst = []
        for stereo in (False, True):
            k_x, k_ginfo = K.requant_stereo_fused(buf, t, lines, mono, stereo)
            x4, g4 = K.requant_stereo(got, stereo)
            check(torch.equal(k_x, x4) and torch.equal(k_ginfo, g4),
                  f"K1 wire {label} (stereo={stereo}): differs from K4 -> K1")
            ref_x, ref_ginfo = k1_ref(buf, t, stereo, tail_lines=lines, mono=mono)
            check(torch.equal(k_ginfo, ref_ginfo), f"K1 wire {label}: ginfo differs")
            worst.append(_rel_per_granule(k_x, ref_x))
        b = k1_batch(buf, t, lines, mono)
        e_st = _rel_per_granule(k_x, G._stereo(b, K.requant_stereo_fused(
            buf, t, lines, mono, stereo=False)[0]))
        check(worst[0] <= 2e-5 and e_st <= 1e-6 and worst[1] <= 2e-5,
              f"K1 wire {label} bound")
        say(f"phase 2 K4 unpack_fused [{label}]: S={s} T={t} L={lines} "
            f"({buf_np.shape[1]} B/row): equal to plain and to the source; "
            f"K1 on the wire bit-identical to K4 -> K1, "
            f"requant rel {worst[0]:.3e} (<= 2e-5), stereo rel {e_st:.3e} "
            f"(<= 1e-6), whole rel {worst[1]:.3e} against plain")
    buf = torch.from_numpy(wire_chunk(SEED + 10, s_dim, t_dim, 512, False)[0]).to(dev)
    row = {
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: K.unpack_fused(buf, t_dim, 512)),
        "plain_ms": time_ms(lambda: G.unpack_fused_ref(buf, t_dim, 512)),
        **bound(nbytes(buf, *K.unpack_fused(buf, t_dim, 512)), 0.0),
    }
    small = torch.from_numpy(wire_chunk(SEED + 17, 1, 128, 512, False)[0]).to(dev)
    row["shapes"] = {"S=1 T=128": {
        "ms": time_ms(lambda: K.unpack_fused(small, 128, 512)),
        **bound(nbytes(small, *K.unpack_fused(small, 128, 512)), 0.0)}}
    say(f"phase 2 time unpack_fused: kernel {row['ms']:.4f} ms (one launch), plain "
        f"{row['plain_ms']:.4f} ms (S={s_dim}, T={t_dim}, L=512, "
        f"{buf.numel() / 1e6:.1f} MB in); at S=1 T=128: kernel "
        f"{row['shapes']['S=1 T=128']['ms']:.4f} ms")
    return row


def phase_graph(dev, t_dim: int, k: int = 4) -> dict:
    """A k-chunk segment of a stereo and a mono group, twice in a row (the
    state carried from the first into the second): SegmentGraph replays
    against run_segment_eager, bit for bit."""
    import torch

    from go_mp3_tpu_torch.ops.granule import DecodeState, state_from_numpy
    from go_mp3_tpu_torch.parallel.segment import (
        SegmentGraph,
        run_segment_eager,
        static_slots,
    )

    groups = ((N_STEREO, 464, False), (N_MONO, 301, True))
    widths = tuple(g[1] for g in groups)
    monos = tuple(g[2] for g in groups)
    rng = np.random.default_rng(SEED + 20)

    def segment(seed):
        bufs, valids = [], []
        for gi, (s, lines, mono) in enumerate(groups):
            rows, vs = [], []
            for c in range(k):
                buf, _, v = wire_chunk(seed + 10 * gi + c, s, t_dim, lines, mono)
                v[rng.integers(s)] = 0
                rows.append(buf)
                vs.append(v)
            bufs.append(torch.from_numpy(np.stack(rows)).to(dev))
            valids.append(torch.from_numpy(np.stack(vs)).to(dev))
        return bufs, valids

    segs = [segment(SEED + 100), segment(SEED + 200)]
    st0 = tuple(state_from_numpy(
        (rng.standard_normal((s, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((s, 2, 16, 64)) * 0.05).astype(np.float32), dev)
        for s, _, _ in groups)

    eager, st = [], st0
    for bufs, valids in segs:
        pcm, st = run_segment_eager(bufs, valids, st, t_dim, widths, monos)
        eager.append((pcm, st))

    slots = static_slots(k, t_dim, [g[0] for g in groups], dev)
    for dst, src in zip(slots[1], st0):
        dst.store.copy_(src.store)
        dst.v_fifo.copy_(src.v_fifo)
    graph = SegmentGraph(t_dim, widths, monos, *slots)
    captured = {n: c for n, c in graph.launches.items() if c}
    check(captured == {"chain": k * len(groups), "chain_fused": k * len(groups)},
          f"SegmentGraph: captured {captured}, not one chain launch per chunk and group")
    worst = 0
    for i, ((bufs, valids), (pcm_e, st_e)) in enumerate(zip(segs, eager)):
        for dst, src in zip(graph.bufs, bufs):
            dst.copy_(src)
        for dst, src in zip(slots[0], valids):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for g in range(len(groups)):
            d = int((slots[2][g].int() - pcm_e[g].int()).abs().max())
            worst = max(worst, d)
            check(d == 0, f"SegmentGraph replay {i}: PCM of group {g} differs ({d} LSB)")
            check(torch.equal(slots[1][g].store, st_e[g].store)
                  and torch.equal(slots[1][g].v_fifo, st_e[g].v_fifo),
                  f"SegmentGraph replay {i}: state of group {g} differs")
    say(f"phase 3 SegmentGraph: k={k}, groups {groups} (lanes, width, mono), "
        f"two replays with the state carried: PCM and state bit-identical to "
        f"run_segment_eager; {sum(graph.launches[k] for k in KERNEL_ROWS)} kernel "
        f"launches captured per replay {graph.launches}; capture (warm-up included) "
        f"{graph.capture_seconds:.3f} s")
    bufs, valids = segs[0]
    st_copy = [DecodeState(s.store.clone(), s.v_fifo.clone()) for s in slots[1]]
    # the segment's bytes: the wire and valid counts in, the PCM out, the
    # state in and out; its operations: the chain on every chunk of each group
    seg_bytes = nbytes(*bufs, *valids, *slots[2]) + 2 * sum(
        nbytes(st.store, st.v_fifo) for st in slots[1])
    seg_flops = sum(k * chain_flops(s, t_dim)
                    for s, _, _ in groups)
    row = {
        "max_abs_err": float(worst),
        "ms": time_ms(graph.replay),
        "plain_ms": time_ms(lambda: run_segment_eager(
            bufs, valids, st_copy, t_dim, widths, monos)),
        **bound(seg_bytes, seg_flops),
    }
    say(f"phase 3 time segment_graph: one replay {row['ms']:.4f} ms, the "
        f"eager segment {row['plain_ms']:.4f} ms (k={k}, T={t_dim}, "
        f"{N_STEREO} + {N_MONO} lanes)")
    return row


def _iso(a: bytes, b: bytes, what: str) -> tuple[float, int]:
    from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, iso_metrics

    rms, mx = iso_metrics(a, b)
    check(rms < FULL_RMS and mx <= FULL_MAXDIFF,
          f"{what}: not ISO full compliance (RMS {rms}, max {mx})")
    return rms, mx


def phase_decoder(dev, times: int = 300) -> tuple[bytes, bytes, bytes]:
    """-> (the stream, the Decoder's read_all, the exact backend's)."""
    import torch

    from go_mp3_tpu_torch import Decoder, reference

    data = (ROOT / "conformance" / "synthetic_escape.mp3").read_bytes() * times
    t0 = time.perf_counter()
    d = Decoder(data, device=dev)
    pcm = d.read_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    secs = len(pcm) / 4 / d.sample_rate()
    check(len(pcm) == d.length(), "Decoder: read_all length != length()")
    exact = reference.decode_exact(data)
    rms, mx = _iso(pcm, exact, "Decoder read_all")
    seek_to = min(30.0, d.duration() / 2)
    n = 4 * d.sample_rate() * 5
    reads = []
    for dec in (d, reference.exact_decoder(data)):
        dec.seek_to_time(seek_to)
        reads.append((dec.tell(), dec.read(n)))
    check(reads[0][0] == reads[1][0] and len(reads[0][1]) == len(reads[1][1]) > 0,
          "Decoder seek: position or length differs")
    srms, smx = _iso(reads[0][1], reads[1][1], "Decoder after seek")
    ck = d.checkpoint_bytes()  # state on the card -> bytes -> a new Decoder
    rest = d.read(n)
    d2 = Decoder(data, device=dev)
    d2.resume_bytes(ck)
    check(d2.checkpoint_bytes() == ck and d2.read(n) == rest,
          "Decoder checkpoint/resume did not round-trip")
    say(f"phase 4 Decoder: {secs:.2f} s of audio in {wall:.3f} s "
        f"({secs / wall:.1f}x realtime, one stream); vs exact RMS {rms:.4f} "
        f"max {mx}; seek_to_time({seek_to}) + 5 s read RMS {srms:.4f} max "
        f"{smx}; checkpoint/resume round-trips; PCM sha256 {sha256(pcm)}")
    check_parent("phase 4 PCM sha256", sha256(pcm))
    return data, pcm, exact


class _NonSeekable:
    """A pipe-like reader over bytes: no seek, no tell."""

    def __init__(self, data: bytes):
        self._data, self._pos = data, 0

    def read(self, n: int = -1) -> bytes:
        end = len(self._data) if n is None or n < 0 else self._pos + n
        out = self._data[self._pos:end]
        self._pos += len(out)
        return out

    def seekable(self) -> bool:
        return False


K1_ROUTES = ("int16", "granule_batch", "fused")  # K1's counted routes


STAGE_KERNELS = ("requant_stereo", "hybrid", "synth", "unpack_fused")  # K1-K4


def _check_chain(counts: dict, what: str, route: str | None) -> None:
    """The chain kernel ran, every launch with K1 on `route` (one of
    K1_ROUTES, or None: the int8 interface), and K1-K4 never."""
    check(counts["chain"] > 0, f"{what}: the chain kernel never ran ({counts})")
    for r in K1_ROUTES:
        check((counts["chain_" + r] == counts["chain"]) == (r == route),
              f"{what}: the chain's {r} route ran {counts['chain_' + r]} of "
              f"{counts['chain']} times")
    for n in STAGE_KERNELS:
        check(counts[n] == 0, f"{what}: {n} ran {counts[n]} times on the main path")


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


class _Launches:
    """Runs a main-path call with the launch counts (and the peak device
    memory) at 0 just before it, reads them just after, checks that
    torch's current device did not move and adds the counts to `totals`.
    Every main-path run of phases 4-7 goes through run()."""

    def __init__(self):
        import torch

        self.home = torch.cuda.current_device()
        self.totals: dict = {}

    def run(self, what: str, fn):
        """-> (fn(), wall seconds, the run's launch counts)."""
        import torch

        from go_mp3_tpu_torch.ops import kernels as K
        from go_mp3_tpu_torch.parallel.segment import SegmentGraph

        _sync_all()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        SegmentGraph.replays = 0
        t0 = time.perf_counter()
        out = fn()
        _sync_all()
        wall = time.perf_counter() - t0
        counts = {**K.all_counts(), "segment_graph": SegmentGraph.replays}
        check(torch.cuda.current_device() == self.home,
              f"{what}: torch's current device moved from {self.home} to "
              f"{torch.cuda.current_device()}")
        for name, n in counts.items():
            self.totals[name] = self.totals.get(name, 0) + n
        return out, wall, counts


def phase_decoder_paths(dev, data: bytes, native_pcm: bytes, exact: bytes) -> dict:
    """The Decoder's pure-Python parse path, its streaming source and a
    GaplessDecoder on phase 4's stream. -> launches summed over the three."""
    from go_mp3_tpu_torch import Decoder, GaplessDecoder, NotSeekableError, lameinfo

    runs = _Launches()
    paths = (
        ("use_native=False", lambda: Decoder(data, use_native=False, device=dev),
         "granule_batch"),
        ("non-seekable source", lambda: Decoder(_NonSeekable(data), device=dev), "int16"),
        ("GaplessDecoder", lambda: GaplessDecoder(data, device=dev), "int16"),
    )
    for label, make, route in paths:
        def read(make=make):
            d = make()
            return d, d.read_all()

        (d, pcm), wall, counts = runs.run(f"phase 4b {label}", read)
        _check_chain(counts, f"phase 4b {label}", route)
        secs = len(pcm) / 4 / d.sample_rate()
        if label == "GaplessDecoder":
            # no LAME tag on this stream: the decoder delay alone is cut
            check(d.info is None and pcm == native_pcm[4 * lameinfo.DECODER_DELAY:],
                  "phase 4b GaplessDecoder: not phase 4's read past the delay")
            detail = f"= phase 4's read past {lameinfo.DECODER_DELAY} samples"
        else:
            check(pcm == native_pcm, f"phase 4b {label}: PCM differs from phase 4's")
            rms, mx = _iso(pcm, exact, f"phase 4b {label}")
            detail = f"= phase 4's read; vs exact RMS {rms:.4f} max {mx}"
        if label == "non-seekable source":
            check(d.length() == -1, "phase 4b streaming: length() is not -1")
            try:
                d.seek(0)
                check(False, "phase 4b streaming: seek did not raise")
            except NotSeekableError:
                pass
            detail += "; length() -1, seek raises NotSeekableError"
        say(f"phase 4b Decoder [{label}]: {secs:.2f} s of audio in {wall:.3f} "
            f"s ({secs / wall:.1f}x realtime) {detail}; launches {counts}")
    return runs.totals


def _lanes_from_device(pcm, valids) -> list[bytes]:
    """fetch=False's (pcm [C, S, T*576, 2] on the card, valids [C, S]) ->
    per-lane PCM bytes, for the check only."""
    host = pcm.cpu().numpy()
    return [b"".join(host[c, s, : valids[c, s] * 576].tobytes()
                     for c in range(len(valids)) if valids[c, s])
            for s in range(host.shape[1])]


# bench.py's production settings (bench.py:150-155), drain=4 on top
BENCH_SETTINGS = {"chunk_t": 240, "tail_buckets": (464, 512), "n_threads": 8,
                  "drain": 4}
CORPUS_RUNS = (  # (label, decode_corpus_fast keywords)
    ("defaults cold", {}),
    ("defaults warm", {}),
    ("fused=False", {"fused": False}),
    ("n_threads=8", {"n_threads": 8}),
    ("bench settings cold", BENCH_SETTINGS),
    ("bench settings warm", BENCH_SETTINGS),
    ("fetch=False", {"fetch": False}),
)


def phase_corpus(dev, lanes: list[bytes]) -> dict:
    """The corpus runs of CORPUS_RUNS (a configuration's first run pays
    one-time set-up such as pinned host buffers, the caching allocator and
    module loading, so the defaults and the bench settings run twice). Every run gives the same bytes, checked lane by lane against
    the exact backend. Each run starts with the launch counts at 0 and
    reads them at its end. -> launches summed over the runs."""
    import torch

    from go_mp3_tpu_torch import decode_corpus_fast
    from go_mp3_tpu_torch.reference import decode_exact, index_stream

    def device_allocs() -> int:  # the caching allocator's cudaMalloc calls
        return torch.cuda.memory_stats().get("num_device_alloc", 0)

    launches, runs = _Launches(), []
    for label, kw in CORPUS_RUNS:
        allocs = device_allocs()
        res, wall, counts = launches.run(
            f"phase 5 corpus {label}",
            lambda kw=kw: decode_corpus_fast(lanes, device=dev, **kw))
        peak = (torch.cuda.max_memory_allocated() / 2**20, device_allocs() - allocs)
        if isinstance(res, tuple):  # fetch=False: PCM on the card
            shape = tuple(res[0].shape)
            res, pcm = res.stats, _lanes_from_device(*res)
            label += f" (PCM left on the card as {shape} int16)"
        else:
            pcm = res.pcm
        runs.append((label, kw, res, pcm, wall, peak, counts))

    base = runs[0][3]
    for run in runs[1:]:
        check(run[3] == base, f"corpus {run[0]}: PCM differs from the first run")
    rates = [index_stream(d)[2] for d in lanes]
    audio = sum(len(p) / 4 / sr for p, sr in zip(base, rates))
    granules = runs[0][2].granules
    with ThreadPoolExecutor(max_workers=8) as pool:
        refs = list(pool.map(decode_exact, lanes))
    worst = (0.0, 0)
    for i, (got, ref) in enumerate(zip(base, refs)):
        rms, mx = _iso(got, ref, f"corpus lane {i}")
        worst = (max(worst[0], rms), max(worst[1], mx))
    say(f"phase 5 corpus: {len(lanes)} lanes ({N_STEREO} stereo + {N_MONO} "
        f"mono), {granules} granules, {audio:.2f} s of audio; all "
        f"{len(runs)} runs byte-identical; every lane ISO full vs exact "
        f"(worst RMS {worst[0]:.4f}, max {worst[1]}); PCM sha256 (the lanes "
        f"joined in order) {sha256(b''.join(base))}")
    check_parent("phase 5 PCM sha256", sha256(b''.join(base)))

    for label, kw, res, _, wall, peak, counts in runs:
        ph = res.phase_seconds
        card = ph["h2d"] + ph["kernels"] + ph["d2h"]
        widths = {}
        for w in res.chunk_widths:
            widths[w] = widths.get(w, 0) + 1
        line = (f"phase 5 corpus [{label}] {kw}: wall {wall:.3f} s -> "
                f"{audio / wall:.1f}x realtime; host: parse {ph['parse']:.3f} "
                f"s, pack {ph['pack']:.3f} s, emit {ph['emit']:.3f} s; card, "
                f"overlapping the host: h2d {ph['h2d']:.4f} s, kernels "
                f"{ph['kernels']:.4f} s, d2h {ph['d2h']:.4f} s, busy "
                f"{100 * card / wall:.1f}% of the wall; chunk widths "
                f"{widths or 'three-array interface'}; wire "
                f"{res.wire_bytes / res.granules:.1f} B/granule; graph replays "
                f"{res.graph_replays}, captures {res.graph_capture_seconds:.3f} s")
        say(f"{line}; peak device memory {peak[0]:.0f} MiB, {peak[1]} device "
            f"allocations; launches {counts}")
        _check_chain(counts, f"corpus [{label}]",
                     "fused" if kw.get("fused", True) else None)
        check((counts["segment_graph"] > 0) == ("drain" in kw),
              f"corpus [{label}]: {counts['segment_graph']} graph replays")
    return launches.totals, base


def phase_public_unpack(dev, lanes: list[bytes], t_dim: int = 240) -> dict:
    """The public unpack_fused (K4) on the corpus's own wire: the first
    chunk of each lane group (the stereo and the mono lanes of
    corpus_lanes) parsed by the C++ parser, built into fused rows at the
    chunk's tail cap, unpacked on the card, equal to the parser's arrays.
    -> its launches."""
    import torch

    from go_mp3_tpu_torch.native.lib import BatchParser
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops import wire as W

    runs = _Launches()
    for label, group, mono in (("stereo", lanes[:N_STEREO], False),
                               ("mono", lanes[N_STEREO:], True)):
        s_dim = len(group)
        arrays = (np.zeros((s_dim, t_dim, 1024), np.int8),
                  np.zeros((s_dim, t_dim, 128), np.int16),
                  np.zeros((s_dim, t_dim, 168), np.uint8))
        valids = np.zeros(s_dim, np.int32)
        parser = BatchParser(group)
        try:
            parser.parse_chunk_into(*arrays, valids)
        finally:
            parser.close()
        lines = W.tail_cap_lines(arrays[0])
        build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
        buf = torch.from_numpy(build(*arrays, lines)).to(dev)
        got, wall, counts = runs.run(f"phase 5c unpack_fused [{label}]",
                                     lambda: K.unpack_fused(buf, t_dim, lines, mono))
        check(counts["unpack_fused"] == 1, f"phase 5c [{label}]: launches {counts}")
        for name, a, want in zip(("tail8", "head16", "side8"), got, arrays):
            check(np.array_equal(a.cpu().numpy(), want),
                  f"phase 5c [{label}]: {name} differs from the parser's")
        say(f"phase 5c unpack_fused [{label}]: the corpus's first chunk, "
            f"{s_dim} lanes x {t_dim} granules ({int(valids.sum())} valid), tail "
            f"cap {lines}, {buf.numel()} B of wire: equal to the parser's arrays "
            f"({wall * 1e3:.3f} ms); launches {counts}")
    return runs.totals


def phase_decode_corpus(dev, lanes: list[bytes], depth: int = 768):
    """decode_corpus over `lanes` cut to their first `depth` granules,
    against decode_corpus_fast(fused=False) on the same cut lanes and the
    exact backend. -> (its launches, the parsed streams, its PCM)."""
    from go_mp3_tpu_torch import decode_corpus_fast
    from go_mp3_tpu_torch.parallel import decode_corpus, parse_stream_granules
    from go_mp3_tpu_torch.reference import decode_exact, index_stream

    cut, rates, full = [], [], []
    for lane in lanes:
        starts, bpf, sr = index_stream(lane)
        per_frame = bpf // SAMPLES_PER_GR_BYTES  # granules
        cut.append(lane[: int(starts[depth // per_frame])])
        rates.append(sr)
        full.append(len(starts) * per_frame)
    t0 = time.perf_counter()
    streams = [parse_stream_granules(d) for d in cut]
    parse_s = time.perf_counter() - t0
    check(all(len(s) == depth for s in streams),
          f"phase 5b: lanes parsed to {sorted({len(s) for s in streams})} granules")

    runs = _Launches()
    res, wall, counts = runs.run("phase 5b decode_corpus", lambda: decode_corpus(
        streams, chunk_t=128, device=dev))
    _check_chain(counts, "phase 5b decode_corpus", "granule_batch")

    fast = decode_corpus_fast(cut, chunk_t=128, fused=False, device=dev)
    check(res.pcm == fast.pcm, "phase 5b: decode_corpus differs from "
          "decode_corpus_fast(fused=False) on the same lanes")
    with ThreadPoolExecutor(max_workers=8) as pool:
        refs = list(pool.map(decode_exact, cut))
    worst = (0.0, 0)
    for i, (got, ref) in enumerate(zip(res.pcm, refs)):
        rms, mx = _iso(got, ref, f"phase 5b lane {i}")
        worst = (max(worst[0], rms), max(worst[1], mx))
    audio = sum(len(p) / 4 / sr for p, sr in zip(res.pcm, rates))
    ph = res.phase_seconds
    say(f"phase 5b decode_corpus: {len(cut)} lanes cut to {depth} granules "
        f"each (of {min(full)}-{max(full)}), "
        f"{res.granules} granules, {audio:.2f} s of audio, chunk_t=128; "
        f"parse_stream_granules {parse_s:.3f} s, decode_corpus wall "
        f"{wall:.3f} s (pack {ph['pack']:.3f} s, h2d {ph['h2d']:.4f} s, "
        f"kernels {ph['kernels']:.4f} s, d2h {ph['d2h']:.4f} s, emit "
        f"{ph['emit']:.3f} s) -> {audio / wall:.1f}x realtime, "
        f"{audio / (parse_s + wall):.1f}x with the parse; byte-identical to "
        f"decode_corpus_fast(fused=False); every lane ISO full vs exact "
        f"(worst RMS {worst[0]:.4f}, max {worst[1]}); launches {counts}")
    return runs.totals, streams, res.pcm


MESH_RUNS = (  # (label, decode_corpus_fast keywords) per mesh
    ("defaults", {}),
    ("bench settings", BENCH_SETTINGS),
    ("fetch=False", {"fetch": False}),
)


def phase_mesh(dev, lanes: list[bytes], corpus_pcm: list[bytes],
               py_streams, py_pcm) -> dict:
    """The stream mesh over every card (make_mesh()) and over two entries
    of `dev`: decode_corpus_fast with MESH_RUNS, byte-identical to phase
    5's PCM; make_sharded_decoder and make_sharded_packed_decoder on the
    phase-2 batch, two chunks with the state carried, bit-identical to
    decode_chunk; decode_corpus(decode_fn=make_sharded_decoder(...)) on
    phase 5b's parsed lanes, byte-identical to phase 5b. Every run starts
    with the launch counts at 0 and checks that the current device did
    not move. -> launches summed over the runs."""
    import torch

    from go_mp3_tpu_torch import decode_corpus_fast
    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops.kernels import decode_chunk
    from go_mp3_tpu_torch.parallel import decode_corpus, make_mesh
    from go_mp3_tpu_torch.parallel.mesh import (
        make_sharded_decoder,
        make_sharded_packed_decoder,
    )
    from go_mp3_tpu_torch.reference import index_stream

    runs = _Launches()
    pair = make_mesh([dev, dev])
    meshes = (("make_mesh()", make_mesh()),
              (f"[{', '.join(map(str, pair.devices))}]", pair))
    audio = sum(len(p) / 4 / index_stream(d)[2] for p, d in zip(corpus_pcm, lanes))

    # the sharded decoders on the phase-2 batch, inputs from the host
    p16, _, valid, state, _ = smoke_batch(S_SMOKE, T_SMOKE, dev)
    batch = G.GranuleBatch(*(f.contiguous() for f in G.batch_from_packed(*p16)))

    def two_chunks(decode, inputs):
        st, out = state, []
        for _ in range(2):
            pcm, st = decode(*inputs, st, valid)
            out.append(pcm.cpu())
        return out, st.cpu() if hasattr(st, "cpu") else st

    def chunk_ref(*args):  # decode_chunk, called as the sharded decoders are
        *arrays, st, v = args
        return decode_chunk(arrays[0] if len(arrays) == 1 else tuple(arrays), st, v)

    routes = (  # (name, maker, the inputs on the card)
        ("make_sharded_decoder", make_sharded_decoder, (batch,)),
        ("make_sharded_packed_decoder", make_sharded_packed_decoder, p16),
    )
    refs = [two_chunks(chunk_ref, inputs) for _, _, inputs in routes]
    for label, mesh in meshes:
        for (name, make, inputs), (ref, ref_state) in zip(routes, refs):
            host = (G.GranuleBatch(*(f.cpu() for f in inputs[0])),) \
                if name == "make_sharded_decoder" else tuple(a.cpu() for a in inputs)
            (out, st), wall, counts = runs.run(
                f"phase 6 {name} {label}", lambda: two_chunks(make(mesh), host))
            check(all(torch.equal(a, b) for a, b in zip(out, ref)),
                  f"phase 6 {name} on {label}: PCM differs from decode_chunk")
            check(torch.equal(st.store, ref_state.store.cpu())
                  and torch.equal(st.v_fifo, ref_state.v_fifo.cpu()),
                  f"phase 6 {name} on {label}: state differs from decode_chunk")
            _check_chain(counts, f"phase 6 {name} on {label}",
                         "granule_batch" if name == "make_sharded_decoder" else "int16")
            say(f"phase 6 {name} on {label}: 2 chunks of [{S_SMOKE}, {T_SMOKE}] "
                f"with the state carried in {wall:.4f} s (host inputs, PCM "
                f"gathered on the host); PCM and state bit-identical to "
                f"decode_chunk; launches {counts}")

    # decode_corpus_fast on the mesh
    for label, mesh in meshes:
        split = [(str(d), hi - lo) for d, lo, hi in mesh.blocks(len(lanes))]
        for run_label, kw in MESH_RUNS:
            res, wall, counts = runs.run(
                f"phase 6 corpus {run_label} on {label}",
                lambda kw=kw: decode_corpus_fast(lanes, mesh=mesh, **kw))
            if isinstance(res, tuple):  # fetch=False: PCM left on the cards
                blocks = [tuple(p.shape) for p in res[0]]
                pcm = _lanes_from_device(torch.cat([p.cpu() for p in res[0]], 1),
                                         res[1])
                res = res.stats
                run_label += f" (PCM left on the cards as {blocks} int16)"
            else:
                pcm = res.pcm
            check(pcm == corpus_pcm,
                  f"phase 6 corpus {run_label} on {label}: PCM differs from phase 5")
            _check_chain(counts, f"phase 6 corpus {run_label} on {label}", "fused")
            check((counts["segment_graph"] > 0) == ("drain" in kw),
                  f"phase 6 corpus {run_label}: {counts['segment_graph']} graph replays")
            ph = res.phase_seconds
            say(f"phase 6 corpus [{run_label}] on {label}, lanes per entry "
                f"{split}: wall {wall:.3f} s -> {audio / wall:.1f}x realtime; "
                f"host: parse {ph['parse']:.3f} s, pack {ph['pack']:.3f} s, emit "
                f"{ph['emit']:.3f} s; card, summed over the entries: h2d "
                f"{ph['h2d']:.4f} s, kernels {ph['kernels']:.4f} s, d2h "
                f"{ph['d2h']:.4f} s; graph replays {res.graph_replays}, captures "
                f"{res.graph_capture_seconds:.3f} s; byte-identical to phase 5; "
                f"launches {counts}")

    # decode_corpus with a sharded decode_fn
    for label, mesh in meshes:
        res, wall, counts = runs.run(
            f"phase 6 decode_corpus on {label}",
            lambda: decode_corpus(py_streams, chunk_t=128,
                                  decode_fn=make_sharded_decoder(mesh)))
        check(res.pcm == py_pcm, f"phase 6 decode_corpus on {label}: PCM differs "
              "from phase 5b")
        _check_chain(counts, f"phase 6 decode_corpus on {label}", "granule_batch")
        say(f"phase 6 decode_corpus(decode_fn=make_sharded_decoder) on {label}: "
            f"{res.granules} granules, wall {wall:.3f} s; byte-identical to "
            f"phase 5b; launches {counts}")
    say(f"phase 6 mesh: torch.cuda.current_device() stayed {runs.home} through "
        f"every run ({torch.cuda.device_count()} visible card(s))")
    return runs.totals


def phase_conformance() -> dict:
    """python -m go_mp3_tpu_torch.conformance --device cuda, in this
    process. -> its launches."""
    from go_mp3_tpu_torch import conformance

    runs = _Launches()
    rc, wall, counts = runs.run("phase 7 conformance",
                                lambda: conformance.main(["--device", "cuda"]))
    check(rc == 0, f"phase 7: the conformance bundle failed (exit {rc})")
    check(all(counts[n] > 0 for n in ("chain", "chain_fused", "segment_graph")),
          f"phase 7: a kernel never ran ({counts})")
    check(not any(counts[n] for n in STAGE_KERNELS),
          f"phase 7: a kernel of K1-K4 ran on the main path ({counts})")
    say(f"phase 7 conformance on cuda: passed in {wall:.3f} s; launches {counts}")
    return runs.totals


def _tool_json(fn, log: Path) -> tuple:
    """fn() with its standard output written to `log` -> (fn's return
    value, the JSON object on the output's last line)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn()
    log.parent.mkdir(parents=True, exist_ok=True)
    log.write_text(buf.getvalue())
    return rc, json.loads(buf.getvalue().splitlines()[-1])


# phase 2's rows beside profile_device's variants: (row, its route or None)
PHASE2_OF_VARIANT = {
    "unpack (K4)": (("unpack_fused", None),),
    "+requant+stereo (K1, int8)": (("requant_stereo", None),),
    "+requant+stereo (K1, wire)": (("requant_stereo", "fused"),),
    "+aa+imdct+overlap (K1 -> K2)": (("requant_stereo", None), ("hybrid", None)),
    "full chunk (K5)": (("chain", None),),
}


def phase_tools(dev, data: bytes, native_pcm: bytes, rows: dict) -> dict:
    """Phase 8: the port's tools (go_mp3_tpu_torch/tools/) on the card,
    through their entry points. Each decoding run goes through _Launches;
    profile_device's timing loops, like phase 2's, are not main-path runs
    and are not counted. -> the launches summed over the counted runs."""
    from go_mp3_tpu_torch.tools import (
        bench_single,
        compliance,
        example,
        profile_decode,
        profile_device,
    )
    runs = _Launches()
    card = card_identity()
    logs = ROOT / "build" / "traces"

    for f in sorted((ROOT / "conformance").glob("synthetic_*.mp3")):
        (rc, r), wall, counts = runs.run(f"phase 8 compliance {f.name}", lambda f=f: _tool_json(
            lambda: compliance.main([str(f), "--backend", "device", "--oracle-backend",
                                     "exact", "--json"]), logs / f"compliance_{f.stem}.log"))
        check(rc == 0 and r["verdict"] == "FULL COMPLIANCE" and r["offset"] == 0
              and r["device"] == card, f"phase 8 compliance {f.name}: exit {rc}, {r}")
        _check_chain(counts, f"phase 8 compliance {f.name}", "int16")
        say(f"phase 8 compliance {f.name} (device vs exact on {r['device']}): "
            f"{r['verdict']}, offset {r['offset']}, RMS {r['rms']:.6f}, max "
            f"{r['max_diff']} over {r['total_samples']} samples ({wall:.3f} s); "
            f"launches {counts}")

    bench, wall, counts = runs.run("phase 8 bench_single", lambda: bench_single.rows(
        fixtures=("small",), backends=("exact", "device"), device=dev, reps=1))
    by = {r["backend"]: r for r in bench}
    check(by["device"]["device"] == card and by["exact"]["device"] == "cpu"
          and by["device"]["bytes_out"] == by["exact"]["bytes_out"] > 0,
          f"phase 8 bench_single: rows {bench}")
    _check_chain(counts, "phase 8 bench_single", "int16")
    for r in bench:
        say(f"phase 8 bench_single: {json.dumps(r)}")

    rc, prof = _tool_json(lambda: profile_device.main(
        ["--s", str(S_SMOKE), "--t", str(T_SMOKE), "--chunks", "4"]),
        logs / "profile_device.log")
    check(rc == 0 and prof["device"] == card and len(prof["rows"]) == 7,
          f"phase 8 profile_device: exit {rc}, {prof}")
    say(f"phase 8 profile_device (S={prof['s']} T={prof['t']}, parsed escape granules; "
        f"card time, ms; beside phase 2's synthetic batch, the same timer), {card}:")
    for r in prof["rows"]:
        p2 = PHASE2_OF_VARIANT.get(r["variant"])
        if p2:
            p2_ms = sum((rows[n]["routes"][route] if route else rows[n])["ms"]
                        for n, route in p2)
            beside = f"phase 2 {' + '.join(n for n, _ in p2)} {p2_ms:.4f}"
        elif r["variant"] == "full chunk (K1 -> K2 -> K3)":
            beside = f"phase 2 K1 -> K2 -> K3 {rows['chain']['k1_k2_k3_ms']:.4f}"
        else:
            beside = "phase 2: no row at this shape"
        say(f"  {r['variant']:44s} {r['ms']:.4f} (plain {r['plain_ms']:.4f}; bound "
            f"{r['bound_ms']:.4f}, {r['bound_by']}); {beside}")

    (rc, trace), wall, counts = runs.run("phase 8 profile_decode", lambda: _tool_json(
        lambda: profile_decode.main([]), logs / "profile_decode.log"))
    check(rc == 0 and trace["device"] == card, f"phase 8 profile_decode: exit {rc}")
    check(counts["chain"] == counts["chain_granule_batch"] + counts["chain_fused"]
          and counts["segment_graph"] > 0
          and not any(counts[n] for n in STAGE_KERNELS),
          f"phase 8 profile_decode: launches {counts}")
    for w in trace["windows"]:
        check(w["chain_events"] > 0 and w["chain_events"] == w["chain_launches"],
              f"phase 8 profile_decode [{w['name']}]: {w['chain_events']} chain-kernel "
              f"events in the trace, {w['chain_launches']} chain launches counted "
              f"({w['graph_replays']} graph replays)")
        top = "; ".join(f"{n[:60]} {r['count']}x {r['us'] / 1e3:.3f} ms"
                        for n, r in list(w["by_name"].items())[:4])
        gaps = "; ".join(
            f"{g['us'] / 1e3:.3f} ms under {g['host_op']} ("
            + ", ".join(f"{n[:50]} {us / 1e3:.3f}" for n, us in g["host_self"][:2]) + ")"
            for g in w["gaps"])
        say(f"phase 8 trace [{w['name']}] ({w['trace']}): window {w['wall_s']:.4f} s "
            f"profiled, {w['unprofiled_wall_s']:.4f} s unprofiled; device busy "
            f"{w['busy_us'] / 1e3:.3f} of {w['window_us'] / 1e3:.3f} ms "
            f"({100 * w['busy_share']:.2f}%); chain kernel {w['chain_events']} events = "
            f"{w['chain_launches']} launches ({w['graph_replays']} graph replays); "
            f"top: {top}; longest idle gaps: {gaps}")
    say(f"phase 8 profile_decode ({wall:.3f} s; full output {logs / 'profile_decode.log'}); "
        f"launches {counts}")

    src, dst = ROOT / "build" / "example_in.mp3", ROOT / "build" / "example_out.wav"
    src.write_bytes(data)
    rc, wall, counts = runs.run("phase 8 example", lambda: example.main([str(src), str(dst)]))
    wav = dst.read_bytes()
    check(rc == 0 and wav[:44] == example.wav_header(len(native_pcm), 44100)
          and wav[44:] == native_pcm, "phase 8 example: the WAV is not phase 4's PCM")
    _check_chain(counts, "phase 8 example", "int16")
    say(f"phase 8 example: {dst.name}, {len(wav)} B, data = phase 4's PCM "
        f"({wall:.3f} s); launches {counts}")
    return runs.totals


def phase_bench(dev, lanes: list[bytes], corpus_pcm: list[bytes]) -> dict:
    """Phase 9: python -m go_mp3_tpu_torch.bench on the smoke corpus, in
    this process, through go_mp3_tpu_torch.bench.main (a run budget of 0 s:
    every schedule runs twice). The energies of every (chunk, lane) whose
    chunk is full (valid == chunk_t) equal numpy's wrapped int32 sum of
    |PCM| over the same granules of phase 5's PCM (lane by lane, the
    granules located by the running sum of the valid counts); the bench
    launched the chain kernel on the wire and the energy kernel, nothing
    else. -> its launches."""
    import os

    from go_mp3_tpu_torch import bench

    runs = _Launches()
    log = ROOT / "build" / "traces" / "bench.log"
    os.environ["GOMP3_RUN_BUDGET_S"] = "0"
    try:
        (run, r), wall, counts = runs.run("phase 9 bench", lambda: _tool_json(
            lambda: bench.main(["--device", str(dev)]), log))
    finally:
        del os.environ["GOMP3_RUN_BUDGET_S"]
    d = r["detail"]
    check(r == run.result and r["value"] > 0 and d["card"] == card_identity()
          and d["device"] == str(dev) and d["n_streams"] == len(lanes)
          and all(len(w) >= 2 for w in d["runs_wall_s"].values())
          and set(d["runs_wall_s"]) == set(bench.SCHEDULES),
          f"phase 9 bench: {r}")
    t = d["chunk_t"]
    offsets = np.cumsum(run.valids, axis=0) - run.valids
    pairs = 0
    for c, s in zip(*np.nonzero(run.valids == t)):
        g0 = int(offsets[c, s])
        lane = np.frombuffer(corpus_pcm[s], np.int16)[g0 * 1152:(g0 + t) * 1152]
        want = np.abs(lane.astype(np.int32)).sum(dtype=np.int32)
        check(lane.size == t * 1152 and run.energies[c, s] == want,
              f"phase 9 bench: chunk {c} lane {s}: energy {run.energies[c, s]}, phase 5's "
              f"PCM gives {want}")
        pairs += 1
    check_parent("phase 9 energies sha256", sha256(np.ascontiguousarray(
        run.energies, np.int32).tobytes()))
    check(pairs > 0 and counts["chain"] > 0 and counts["chain_fused"] == counts["chain"]
          and counts["energy"] > 0
          and not any(counts[n] for n in STAGE_KERNELS) and not counts["segment_graph"],
          f"phase 9 bench: {pairs} full chunks compared; launches {counts}")
    say(f"phase 9 bench (python -m go_mp3_tpu_torch.bench, {wall:.3f} s in all; full output "
        f"{log}): {r['value']:.1f}x realtime [{d['schedule']}], by schedule "
        f"{json.dumps(d['end_to_end_x_by_schedule'])}; runs {json.dumps(d['runs_wall_s'])}; "
        f"parse cpu min {d['parse_full_corpus_cpu_s']['min']:.4f} s, pack "
        f"{d['probe_pack_s_per_chunk']:.5f} s/chunk, upload "
        f"{d['probe_upload_s_per_chunk_fused']:.5f} s/chunk, compute "
        f"{d['probe_compute_s_per_chunk_scan_amortized']:.6f} s/chunk (scan "
        f"{d['probe_scan_total_s']:.5f} s), capture {d['capture_s']:.3f} s, d2h "
        f"{d['d2h_mb_s']:.0f} MB/s, host cores {d['host_cores']}; ceilings (computed) "
        f"{d['decoder_ceiling_x_realtime']:.0f}x / fused "
        f"{d['decoder_ceiling_fused_x_realtime']:.0f}x / pipelined "
        f"{d['decoder_ceiling_pipelined_x_realtime']:.0f}x; energies of {pairs} full "
        f"(chunk, lane) pairs of {run.valids.size} equal phase 5's PCM energies bit for bit; "
        f"launches {counts}")
    return runs.totals


def check_standalone() -> None:
    """No module of jax was imported, and every module loaded from this
    checkout is the port's, this script or one of the tests' helpers."""
    mine = [ROOT / "go_mp3_tpu_torch", ROOT / "tests"]
    for name, mod in list(sys.modules.items()):
        check(name != "jax" and not name.startswith("jax."), f"{name} was imported")
        f = getattr(mod, "__file__", None)
        if f and Path(f).is_absolute() and Path(f).resolve().is_relative_to(ROOT):
            path = Path(f).resolve()
            check(path == Path(__file__).resolve()
                  or any(path.is_relative_to(d) for d in mine),
                  f"{name} was loaded from {path}, outside the port")


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "go_mp3_tpu_torch").is_dir() or not (ROOT / "conformance").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    from go_mp3_tpu_torch.device import resolve_device

    dev = resolve_device(None)
    phase_device()
    rows = phase_kernels(dev, S_SMOKE, T_SMOKE)
    k1_shapes = phase_k1_routes(dev)
    rows["chain"] = phase_chain(dev)
    phase_tiles(dev)
    phase_empty_chunk(dev)
    rows["unpack_fused"] = phase_unpack(dev, S_SMOKE, T_SMOKE)
    phase_chunk_invariance(dev, S_SMOKE, T_SMOKE)
    rows["segment_graph"] = phase_graph(dev, T_SMOKE)
    rows["segment_graph"]["eager_chunk"] = rows.pop("segment_graph_eager_chunk")
    rows["energy"] = phase_energy(dev)

    runs = _Launches()  # the main path's runs start here
    (data, native_pcm, exact), _, decoder = runs.run("phase 4 Decoder",
                                                     lambda: phase_decoder(dev))
    say(f"launches: Decoder {decoder}")
    _check_chain(decoder, "phase 4 Decoder", "int16")
    lanes = corpus_lanes()
    counts = dict(runs.totals)
    corpus_totals, corpus_pcm = phase_corpus(dev, lanes)
    py_totals, py_streams, py_pcm = phase_decode_corpus(dev, lanes)
    for part in (phase_decoder_paths(dev, data, native_pcm, exact),
                 corpus_totals, phase_public_unpack(dev, lanes), py_totals,
                 phase_mesh(dev, lanes, corpus_pcm, py_streams, py_pcm),
                 phase_conformance(), phase_tools(dev, data, native_pcm, rows),
                 phase_bench(dev, lanes, corpus_pcm)):
        for name, n in part.items():
            counts[name] = counts.get(name, 0) + n
    check_standalone()

    k1_row = rows["requant_stereo"]
    k1_row["shapes"] = k1_shapes.pop("int8")
    for label, route in k1_row["routes"].items():
        route["launches"] = counts[label]
        route["shapes"] = k1_shapes[label]
    for label, route in rows["chain"]["routes"].items():
        route["launches"] = counts["chain_" + label]
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **rows[name]}
        for name, (src, rep) in KERNEL_ROWS.items()
    ]
    kernels.append({"name": "segment_graph", "route": "cuda", "graph": True,
                    "source": GRAPH_ROW[0], "replaces": GRAPH_ROW[1],
                    "launches": counts["segment_graph"], **rows["segment_graph"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
