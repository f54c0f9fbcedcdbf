"""Wrappers of the hand-written CUDA kernels K1-K5 (csrc/*.cu).

Each wrapper checks device, dtype, shape and contiguity, then:
 - on CPU tensors, runs the kernel's plain PyTorch version (ops/granule.py);
 - on CUDA tensors, launches the kernel on the current stream of the
   tensors' device, or raises; torch's current device is the same after the
   call as before it (each C entry point makes the tensors' device current
   and restores the caller's: csrc/device_guard.cuh).
   There is no fallback from a CUDA tensor to the plain version.
It allocates outputs and scratch with torch.empty and counts its launches
in `<wrapper>.launches`, a plain integer that only a kernel launch moves.

  requant_stereo  K1  csrc/requant_stereo.cu  load, requantize, stereo
                      (requant_stereo_fused: the same kernel on the wire)
  hybrid          K2  csrc/hybrid.cu          antialias .. freq inversion
  synth           K3  csrc/synth.cu           polyphase, int16 PCM, FIFO
                                              (fused; v stays on chip)
  unpack_fused    K4  csrc/unpack_fused.cu    fused wire -> K1's int8 arrays
  chain           K5  csrc/chain.cu           K1 -> K2 -> K3 in one kernel,
                                              x and x18 kept on chip, a
                                              block per segment of runs
  energy              csrc/energy.cu          per stream, the wrapping int32
                                              sum of |PCM| (the bench's fence)

decode_chunk runs the chain over one [S, T] chunk of any of K1's array
inputs; decode_chunk_fused over one chunk of fused wire rows. On the card
both launch K5 once; K1, K2 and K3 stay public wrappers of their own
kernels, held against K5 and their plain versions by chip_smoke.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..consts import HEAD_WIDTH, SIDE8_WIDTH, SIDE_WIDTH, SP8_TAIL_WIDTH

from . import _build
from . import granule as G
from . import tables as T
from . import wire

_ready_devices: set[int] = set()


def _library(device: torch.device):
    """The kernel library with its tables uploaded to `device`."""
    lib = _build.load()
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _ready_devices:
        def ptr(a):
            return a.ctypes.data

        keep = [  # host copies alive until the synchronous uploads return
            np.ascontiguousarray(T.PRETAB, np.float32),
            T.IS_RATIO_L, T.IS_RATIO_R,
            np.ascontiguousarray(T.LONG_BAND_START[:, :22], np.int32),
            np.ascontiguousarray(T.SHORT_BAND_START3[:, :13], np.int32),
            T.LONG_SFB_OF_LINE.astype(np.uint8),
            (T.REQ_SHORT_SFB_OF_LINE * 3 + T.REQ_SHORT_WIN_OF_LINE).astype(np.uint8),
            (T.SHORT_SFB_OF_LINE * 3 + T.SHORT_WIN_OF_LINE).astype(np.uint8),
        ]
        _check_rc("requant_stereo_init",
                  lib.gomp3_requant_stereo_init(idx, *map(ptr, keep)))
        hyb = [T.CS, T.CA, T.COS_N36, T.SHORT_M3, T.IMDCT_WIN]
        _check_rc("hybrid_init", lib.gomp3_hybrid_init(idx, *map(ptr, hyb)))
        syn = [np.ascontiguousarray(T.SYNTH_N_WIN.T), T.SYNTH_DTBL]
        _check_rc("synth_init", lib.gomp3_synth_init(idx, *map(ptr, syn)))
        _check_rc("chain_init", lib.gomp3_chain_init(idx, *map(ptr, keep + hyb + syn)))
        _ready_devices.add(idx)
    return lib, idx


def _check_rc(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _route(device: torch.device) -> bool:
    """True: launch the kernel; False: run the plain version (CPU only)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


def _check_aligned(t: torch.Tensor, name: str, align: int = 16) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"{name}: not {align}-byte aligned")


_sm_counts: dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


def run_length(units_per_run: int, t_dim: int, want: int, longest: int = 4) -> int:
    """Granules per run of K2, K3 and K5, or per tile of K1: the first
    of longest, longest / 2, ..., 1 at which the chunk splits into at least
    `want` units of work (`units_per_run` units for each run of granules).
    Longer runs of K2 and K3 share more of each run's extra predecessor
    granule, and 4 was the fastest for both kernels at 64 x 240 on an H100.
    No kernel's result depends on it."""
    g = longest
    while g > 1 and units_per_run * -(-t_dim // g) < want:
        g //= 2
    return g


# -- K1 ------------------------------------------------------------------------

# K1's input layouts (csrc/requant_stereo.cu Layout), and the routes whose
# launches are counted apart (all_counts)
_INT16, _INT8, _BATCH, _FUSED = 0, 1, 2, 3
_LAYOUT_ROUTE = {_INT16: "int16", _BATCH: "granule_batch", _FUSED: "fused"}
# granules a block: every tile K1 takes (csrc/requant_stereo.cu)
K1_TILES = (1, 2, 4)


def k1_tile(dev: torch.device, s_dim: int, t_dim: int) -> int:
    """K1's granules a block: the longest tile, up to 4 (the fastest at
    64 x 240 on an H100, on every input), that still gives two blocks per
    SM."""
    return run_length(s_dim, t_dim, 2 * _sm_count(dev), K1_TILES[-1])


def _k1_inputs(packed):
    """Check one of K1's three array inputs -> (layout, tensors, S, T)."""
    if isinstance(packed, G.GranuleBatch):
        dev = packed.spectra.device
        s_dim, t_dim = packed.spectra.shape[:2]
        for name, t in zip(packed._fields, packed):
            dtype, inner = G.BATCH_FIELDS[name]
            _expect(t, name, dtype, (s_dim, t_dim, *inner), dev)
        return _BATCH, tuple(packed), s_dim, t_dim
    if len(packed) == 2:
        layout = _INT16
        specs = [("spectra", torch.int16, 1152), ("side", torch.int16, SIDE_WIDTH)]
    elif len(packed) == 3:
        layout = _INT8
        specs = [("tail8", torch.int8, SP8_TAIL_WIDTH),
                 ("head16", torch.int16, HEAD_WIDTH),
                 ("side8", torch.uint8, SIDE8_WIDTH)]
    else:
        raise ValueError(f"packed chunk has {len(packed)} arrays, expected "
                         "2 or 3, or a GranuleBatch")
    dev = packed[0].device
    s_dim, t_dim = packed[0].shape[:2]
    for t, (name, dtype, width) in zip(packed, specs):
        _expect(t, name, dtype, (s_dim, t_dim, width), dev)
    return layout, tuple(packed), s_dim, t_dim


def requant_stereo(packed, stereo: bool = True):
    """K1 over one of three inputs, each [S, T, ...]:
     - the int16 interface (spectra i16 [S,T,1152], side i16 [S,T,144]);
     - the int8 interface (tail8 i8 [S,T,1024], head16 i16 [S,T,128],
       side8 u8 [S,T,168]);
     - a GranuleBatch, the JAX kernel's own input, each field in its own
       dtype (ops/granule.py BATCH_FIELDS), told apart by its type
    -> (x f32 [S, T, 2, 576], ginfo int32 [S, T]). stereo=False stops
    after requantize, to check the two parts of K1 apart. Its fourth
    input, the fused wire, is requant_stereo_fused's.
    `requant_stereo.int16_launches`, `.batch_launches` and
    `.fused_launches` count the launches of the int16, GranuleBatch and
    wire routes among `requant_stereo.launches`."""
    layout, tensors, s_dim, t_dim = _k1_inputs(packed)
    dev = tensors[0].device
    if not _route(dev):
        return G.requant_stereo_ref(G.batch_from_any(packed), stereo)
    return _requant_stereo_launch(layout, tensors, s_dim, t_dim, stereo,
                                  k1_tile(dev, s_dim, t_dim))


def _check_wire(buf: torch.Tensor, t: int, tail_lines: int, mono: bool) -> None:
    if not 0 <= tail_lines <= wire.TAIL_LINES_FULL:
        raise ValueError(f"tail_lines {tail_lines} outside 0..{wire.TAIL_LINES_FULL}")
    if t < 0:
        raise ValueError(f"t {t} < 0")
    _expect(buf, "buf", torch.uint8,
            (buf.shape[0], wire.stream_nbytes(t, tail_lines, mono)), buf.device)


def requant_stereo_fused(buf: torch.Tensor, t: int, tail_lines: int,
                         mono: bool = False, stereo: bool = True):
    """K1 on the fused wire rows u8 [S, wire.stream_nbytes(t, tail_lines,
    mono)] themselves (ops/wire.py) -> the (x, ginfo) of
    requant_stereo(unpack_fused(buf, t, tail_lines, mono)), with no
    unpacked copy in device memory: the fused corpus path's K1."""
    _check_wire(buf, t, tail_lines, mono)
    s_dim = buf.shape[0]
    if not _route(buf.device):
        return G.requant_stereo_fused_ref(buf, t, tail_lines, mono, stereo)
    return _requant_stereo_launch(_FUSED, (buf,), s_dim, t, stereo,
                                  k1_tile(buf.device, s_dim, t),
                                  tail_lines, mono)


def _requant_stereo_launch(layout, tensors, s_dim, t_dim, stereo, g: int,
                           tail_lines: int = 0, mono: bool = False):
    """K1's launch on checked CUDA tensors (the inputs of `layout` in
    csrc/requant_stereo.cu's order), `g` granules a block (one of
    K1_TILES; no output depends on it). S == 0 or T == 0 launches
    nothing."""
    dev = tensors[0].device
    _check_k1_alignment(layout, tensors)
    out = torch.empty((s_dim, t_dim, 2, 576), dtype=torch.float32, device=dev)
    ginfo = torch.empty((s_dim, t_dim), dtype=torch.int32, device=dev)
    if not (s_dim and t_dim):
        return out, ginfo
    lib, idx = _library(dev)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    _check_rc("requant_stereo", lib.gomp3_requant_stereo(
        idx, layout, ptrs, out.data_ptr(), ginfo.data_ptr(), s_dim, t_dim, g,
        int(stereo), tail_lines, 1 if mono else 2,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    # the int8 interface has no count of its own: add_counts ignores "int8"
    add_counts({"requant_stereo": 1, _LAYOUT_ROUTE.get(layout, "int8"): 1})
    return out, ginfo


def _k1_any(packed, t, tail_lines, mono):
    """Check one of K1's four inputs -> (layout, tensors, S, T): fused wire
    rows (a tensor, described by t, tail_lines and mono) or the arrays and
    GranuleBatch of _k1_inputs."""
    if isinstance(packed, torch.Tensor):
        if t is None:
            raise ValueError("fused wire rows need t and tail_lines")
        _check_wire(packed, t, tail_lines, mono)
        return _FUSED, (packed,), packed.shape[0], t
    return _k1_inputs(packed)


def _check_k1_alignment(layout, tensors) -> None:
    if layout in (_INT16, _BATCH):
        _check_aligned(tensors[0], "spectra", 8)
    elif layout == _INT8:
        _check_aligned(tensors[0], "tail8", 4)
        _check_aligned(tensors[1], "head16", 8)


# -- K2, K3 --------------------------------------------------------------------


def hybrid(x: torch.Tensor, ginfo: torch.Tensor, store: torch.Tensor,
           valid: torch.Tensor):
    """K2. x f32 [S,T,2,576], ginfo int32 [S,T], store f32 [S,2,32,18],
    valid int32 [S] (0 <= valid <= T) -> (x18 f32 [S,T,2,32,18], store
    after valid granules; a copy of it when T == 0). One warp per (stream,
    channel, run of run_length granules)."""
    dev = x.device
    s_dim, t_dim = x.shape[:2]
    _expect(x, "x", torch.float32, (s_dim, t_dim, 2, 576), dev)
    _expect(ginfo, "ginfo", torch.int32, (s_dim, t_dim), dev)
    _expect(store, "store", torch.float32, (s_dim, 2, 32, 18), dev)
    _expect(valid, "valid", torch.int32, (s_dim,), dev)
    if not _route(dev):
        return G.hybrid_ref(x, ginfo, store, valid)
    return _hybrid_launch(x, ginfo, store, valid,
                          run_length(s_dim * 2, t_dim, 2 * _sm_count(dev)))


def _hybrid_launch(x, ginfo, store, valid, g: int):
    """K2's launch on checked CUDA tensors, `g` granules a warp (any >= 1;
    no output depends on it). T == 0 launches nothing: the C entry point
    copies the store."""
    dev = x.device
    s_dim, t_dim = x.shape[:2]
    lib, idx = _library(dev)
    _check_aligned(x, "x")
    warps = 4 if s_dim * 2 * -(-t_dim // g) >= 4 * _sm_count(dev) else 1
    x18 = torch.empty((s_dim, t_dim, 2, 32, 18), dtype=torch.float32, device=dev)
    store_out = torch.empty_like(store)
    _check_rc("hybrid", lib.gomp3_hybrid(
        idx, x.data_ptr(), ginfo.data_ptr(), store.data_ptr(), valid.data_ptr(),
        x18.data_ptr(), store_out.data_ptr(), s_dim, t_dim, g, warps,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    if s_dim and t_dim:
        hybrid.launches += 1
    return x18, store_out


def synth(x18: torch.Tensor, ginfo: torch.Tensor, v_fifo: torch.Tensor,
          valid: torch.Tensor, out: torch.Tensor | None = None):
    """K3. x18 f32 [S,T,2,32,18], ginfo int32 [S,T], v_fifo f32
    [S,2,16,64], valid int32 [S] -> (pcm int16 [S, T*576, 2], v_fifo
    after valid granules; a copy of it when T == 0). `out`, if given,
    receives the PCM. One block per (stream, run of run_length
    granules)."""
    dev = x18.device
    s_dim, t_dim = x18.shape[:2]
    _expect(x18, "x18", torch.float32, (s_dim, t_dim, 2, 32, 18), dev)
    _expect(ginfo, "ginfo", torch.int32, (s_dim, t_dim), dev)
    _expect(v_fifo, "v_fifo", torch.float32, (s_dim, 2, 16, 64), dev)
    _expect(valid, "valid", torch.int32, (s_dim,), dev)
    if out is not None:
        _expect(out, "out", torch.int16, (s_dim, t_dim * 576, 2), dev)
    if not _route(dev):
        pcm, fifo = G.synth_ref(x18, ginfo, v_fifo, valid)
        return (pcm if out is None else out.copy_(pcm)), fifo
    return _synth_launch(x18, ginfo, v_fifo, valid, out,
                         run_length(s_dim, t_dim, 2 * _sm_count(dev)))


def _synth_launch(x18, ginfo, v_fifo, valid, out, g: int):
    """K3's launch on checked CUDA tensors, `g` granules a block (1-4; no
    output depends on it). T == 0 launches nothing: the C entry point
    copies the FIFO."""
    dev = x18.device
    s_dim, t_dim = x18.shape[:2]
    lib, idx = _library(dev)
    _check_aligned(x18, "x18")
    pcm = out if out is not None else torch.empty(
        (s_dim, t_dim * 576, 2), dtype=torch.int16, device=dev)
    fifo_out = torch.empty_like(v_fifo)
    _check_rc("synth", lib.gomp3_synth(
        idx, x18.data_ptr(), ginfo.data_ptr(), v_fifo.data_ptr(), valid.data_ptr(),
        pcm.data_ptr(), fifo_out.data_ptr(), s_dim, t_dim, g,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    if s_dim and t_dim:
        synth.launches += 1
    return pcm, fifo_out


# -- K4 ------------------------------------------------------------------------


def unpack_fused(buf: torch.Tensor, t: int, tail_lines: int, mono: bool = False):
    """K4. Fused rows u8 [S, wire.stream_nbytes(t, tail_lines, mono)] ->
    (tail8 i8 [S,T,1024], head16 i16 [S,T,128], side8 u8 [S,T,168]), the
    int8 interface of requant_stereo (JAX's public unpack_fused and
    unpack_fused_mono). The corpus path does not run it:
    requant_stereo_fused reads the wire itself."""
    _check_wire(buf, t, tail_lines, mono)
    if not _route(buf.device):
        ref = G.unpack_fused_mono_ref if mono else G.unpack_fused_ref
        return ref(buf, t, tail_lines)
    dev = buf.device
    s_dim = buf.shape[0]
    tail8 = torch.empty((s_dim, t, SP8_TAIL_WIDTH), dtype=torch.int8, device=dev)
    head16 = torch.empty((s_dim, t, HEAD_WIDTH), dtype=torch.int16, device=dev)
    side8 = torch.empty((s_dim, t, SIDE8_WIDTH), dtype=torch.uint8, device=dev)
    if s_dim and t:
        lib, idx = _library(dev)
        _check_rc("unpack_fused", lib.gomp3_unpack_fused(
            idx, buf.data_ptr(), tail8.data_ptr(), head16.data_ptr(),
            side8.data_ptr(), s_dim, t, tail_lines, 1 if mono else 2,
            torch.cuda.current_stream(dev).cuda_stream,
        ))
        unpack_fused.launches += 1
    return tail8, head16, side8


# -- K5 ------------------------------------------------------------------------

# granules a run: every run the chain kernel takes (csrc/chain.cu)
CHAIN_RUNS = (1, 2, 4)
# the shortest segment the chain kernel walks: below it, the segment's halo
# and its first K1, which nothing overlaps, cost more than a block per run
# (L = 1) does (every (G, L) at [64, 240] and [64, 37] on an H100, PERF.md)
MIN_SEGMENT_RUNS = 5
# the least share of its waves' block slots (two an SM) that a walk's blocks
# must fill: a wave's idle slots cost more than the walk gains on one run a
# block (every L at T = 240 and S = 16 .. 300 on an H100, PERF.md)
CHAIN_WAVE_FILL = 0.95


def chain_run(dev: torch.device, s_dim: int, t_dim: int) -> tuple[int, int]:
    """K5's (G, L): a block walks L runs of G granules of one stream. G is
    the longest run, up to 4, at which the chunk still splits into two
    runs per SM. L is the longest segment of at least MIN_SEGMENT_RUNS runs
    whose blocks (S x segments) fill the waves they take, two blocks an SM,
    to CHAIN_WAVE_FILL or more; else 1, the one-run-a-block kernel. On an
    H100 (2 x 132 slots) at T = 240: S = 64 -> (4, 15), 256 blocks in one
    wave; 96 -> (4, 8), 768 in three; 192 -> (4, 15), 768; 300 -> (4, 10),
    1,800 in seven; 16 and 48 -> (4, 1), as [64, 37] and the Decoder's
    [1, 128]. A segment recomputes two granules at its start, where a
    block of one run does so before every run. No output depends on
    either."""
    slots = 2 * _sm_count(dev)
    g = run_length(s_dim, t_dim, slots, CHAIN_RUNS[-1])
    runs = -(-t_dim // g)
    for segments in range(1, runs + 1):
        n = -(-runs // segments)
        if n < MIN_SEGMENT_RUNS:
            break
        blocks = s_dim * -(-runs // n)
        if blocks >= CHAIN_WAVE_FILL * slots * max(1, -(-blocks // slots)):
            return g, n
    return g, 1


def chain_occupancy(dev: torch.device, layout: int, g: int, runs: int) -> tuple[int, int]:
    """The chain kernel's dynamic shared memory a block (bytes) and blocks
    an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for K1's input
    `layout` (_INT16, _INT8, _BATCH, _FUSED), G and L (1: the
    one-run-a-block kernel; any other: the segment walk)."""
    lib, idx = _library(dev)
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    _check_rc("chain_occupancy", lib.gomp3_chain_occupancy(
        idx, layout, g, runs, ctypes.byref(smem), ctypes.byref(blocks)))
    return smem.value, blocks.value


def chain(packed, state: G.DecodeState, valid: torch.Tensor,
          out: torch.Tensor | None = None, *, t: int | None = None,
          tail_lines: int = 0, mono: bool = False):
    """K5, the granule chain: K1 -> K2 -> K3 over one [S, T] chunk in one
    kernel. `packed` is any of K1's four inputs: the int16 or int8 arrays,
    a GranuleBatch, or fused wire rows u8 [S, wire.stream_nbytes(t,
    tail_lines, mono)] (a tensor; then t, tail_lines and mono describe
    it). state: store f32 [S,2,32,18] and v_fifo f32 [S,2,16,64]; valid
    int32 [S] (0 <= valid <= T) -> (pcm int16 [S, T*576, 2], the state after
    each stream's valid granules; a copy of it when T == 0). `out`, if
    given, receives the PCM. One block per stream and segment of
    chain_run's L runs of G granules. On CPU tensors: the plain chain
    (decode_chunk_ref).
    `chain.int16_launches`, `.batch_launches` and `.fused_launches` count
    the launches of those K1 routes among `chain.launches`."""
    layout, tensors, s_dim, t_dim = _k1_any(packed, t, tail_lines, mono)
    dev = tensors[0].device
    _expect(state.store, "store", torch.float32, (s_dim, 2, 32, 18), dev)
    _expect(state.v_fifo, "v_fifo", torch.float32, (s_dim, 2, 16, 64), dev)
    _expect(valid, "valid", torch.int32, (s_dim,), dev)
    if out is not None:
        _expect(out, "out", torch.int16, (s_dim, t_dim * 576, 2), dev)
    if not _route(dev):
        b = (G.batch_from_fused(packed, t_dim, tail_lines, mono) if layout == _FUSED
             else G.batch_from_any(packed))
        pcm, st = G.decode_chunk_ref(b, state, valid)
        return (pcm if out is None else out.copy_(pcm)), st
    return _chain_launch(layout, tensors, s_dim, t_dim, state, valid, out,
                         *chain_run(dev, s_dim, t_dim), tail_lines, mono)


def _chain_launch(layout, tensors, s_dim, t_dim, state: G.DecodeState, valid, out,
                  g: int, runs: int, tail_lines: int = 0, mono: bool = False):
    """K5's launch on checked CUDA tensors (K1's inputs of `layout` in
    csrc/requant_stereo.cu's order): a block per stream and segment of
    `runs` (L >= 1) runs of `g` granules (one of CHAIN_RUNS); no output
    depends on either. T == 0 launches nothing: the C entry point copies
    the state."""
    dev = tensors[0].device
    _check_k1_alignment(layout, tensors)
    pcm = out if out is not None else torch.empty(
        (s_dim, t_dim * 576, 2), dtype=torch.int16, device=dev)
    _check_aligned(pcm, "out", 4)
    store = torch.empty_like(state.store)
    fifo = torch.empty_like(state.v_fifo)
    lib, idx = _library(dev)
    ptrs = (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
    _check_rc("chain", lib.gomp3_chain(
        idx, layout, ptrs, state.store.data_ptr(), state.v_fifo.data_ptr(),
        valid.data_ptr(), pcm.data_ptr(), store.data_ptr(), fifo.data_ptr(),
        s_dim, t_dim, g, runs, tail_lines, 1 if mono else 2,
        torch.cuda.current_stream(dev).cuda_stream,
    ))
    if s_dim and t_dim:
        add_counts({"chain": 1, "chain_" + _LAYOUT_ROUTE.get(layout, "int8"): 1})
    return pcm, G.DecodeState(store=store, v_fifo=fifo)


def decode_chunk(packed, state: G.DecodeState, valid: torch.Tensor,
                 out: torch.Tensor | None = None):
    """One [S, T] chunk of granules (any input of requant_stereo: either
    packed interface or a GranuleBatch) plus the state -> (pcm int16
    [S, T*576, 2], state after each stream's valid granules; the state
    itself, copied, when T == 0): K5 (chain); `out`, if given, receives
    the PCM (decode_chunk_impl and decode_chunk_batch,
    go_mp3_tpu/ops/granule.py:493, :745, :758)."""
    return chain(packed, state, valid, out)


def decode_chunk_fused(buf: torch.Tensor, state: G.DecodeState,
                       valid: torch.Tensor, t: int, tail_lines: int,
                       mono: bool = False, out: torch.Tensor | None = None):
    """decode_chunk over one chunk of fused rows: K5 with K1 reading the
    wire (decode_chunk_fused_batch_impl and decode_chunk_fused_mono_batch_impl,
    go_mp3_tpu/ops/granule.py:726-741)."""
    return chain(buf, state, valid, out, t=t, tail_lines=tail_lines, mono=mono)


# -- energy --------------------------------------------------------------------


def energy(pcm: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Per stream, the int32 sum of |int32(pcm)|, wrapping mod 2^32 as
    XLA's int32 sum does: pcm int16 [S, N, 2] -> int32 [S] (bench.py's
    energy step, bench.py:416-418). `out`, if given, a contiguous int32 [S]
    tensor (such as a row slice energies[c, lo:hi]), receives it. On the
    card N must be a multiple of 4 (a chunk's N is T*576) and pcm 16-byte
    aligned. One block per stream (csrc/energy.cu); S == 0 launches
    nothing."""
    dev = pcm.device
    s_dim, n = pcm.shape[:2]
    _expect(pcm, "pcm", torch.int16, (s_dim, n, 2), dev)
    if out is None:
        out = torch.empty(s_dim, dtype=torch.int32, device=dev)
    _expect(out, "out", torch.int32, (s_dim,), dev)
    if not _route(dev):
        return out.copy_(G.energy_ref(pcm))
    if n % 4:
        raise ValueError(f"pcm: {n} samples a channel, not a multiple of 4")
    _check_aligned(pcm, "pcm")
    if s_dim:
        lib, idx = _library(dev)
        _check_rc("energy", lib.gomp3_energy(
            idx, pcm.data_ptr(), out.data_ptr(), s_dim, 2 * n,
            torch.cuda.current_stream(dev).cuda_stream,
        ))
        energy.launches += 1
    return out


# -- launch counts -------------------------------------------------------------

KERNELS = (requant_stereo, hybrid, synth, unpack_fused, chain, energy)
# K1's routes counted apart, among requant_stereo.launches and chain.launches
# (the int8 interface's are the rest): all_counts() key -> (wrapper, count)
_ROUTES = {
    "int16": (requant_stereo, "int16_launches"),
    "granule_batch": (requant_stereo, "batch_launches"),
    "fused": (requant_stereo, "fused_launches"),
    "chain_int16": (chain, "int16_launches"),
    "chain_granule_batch": (chain, "batch_launches"),
    "chain_fused": (chain, "fused_launches"),
}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    for fn, attr in _ROUTES.values():
        setattr(fn, attr, 0)


reset_launch_counts()


def launch_counts() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def all_counts() -> dict[str, int]:
    """launch_counts() and those of K1's int16, GranuleBatch and wire
    routes, of K1's kernel ("int16", "granule_batch", "fused") and of the
    chain's ("chain_int16", "chain_granule_batch", "chain_fused")."""
    return {**launch_counts(),
            **{r: getattr(fn, a) for r, (fn, a) in _ROUTES.items()}}


def add_counts(delta: dict[str, int]) -> None:
    """Add `delta` (keys of all_counts()) to the counts."""
    for k in KERNELS:
        k.launches += delta.get(k.__name__, 0)
    for r, (fn, a) in _ROUTES.items():
        setattr(fn, a, getattr(fn, a) + delta.get(r, 0))
