"""Where the chain kernel's time goes, on one GPU: variants of
go_mp3_tpu_torch/csrc/chain.cu built beside the package's library, each
timed at [64, 240] on the int8 input and the fused wire (chip_smoke.py's
timer, inputs and K1 -> K2 -> K3 reference).

    python3 tests/chain_probe.py

Variants (the text of the sources changed, nothing else):
  base       the source as it is;
  k1_only, k1_k2, no_fir
             the kernel cut short after K1, after K2 and before the FIR
             (their outputs differ): a stage's cost is the difference;
  t384       384 threads a block instead of 512;
  tile2      the symmetric matrixing with 2 slots a thread (81 threads a
             granule) instead of 3 (54);
  stamped    clock64() of thread 0 at each stage boundary and at K1's steps,
             per block, with its SM id: the mean cycles of each stage.
Each line says whether the variant's output is bit-identical to
K1 -> K2 -> K3. Needs nvcc and a card; not a test.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
CSRC = ROOT / "go_mp3_tpu_torch" / "csrc"
OUT = ROOT / "build" / "chain_probe"
S_DIM, T_DIM, LINES, G = 64, 240, 512, 4

STAMP_HEAD = r"""
__device__ long long g_stamps[16384][16];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned sm;                        \
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                             \
    const int b = blockIdx.y * gridDim.x + blockIdx.x;                          \
    if (b < 16384) { g_stamps[b][i] = clock64(); if (i == 0) g_stamps[b][15] = sm; } \
  } } while (0)
"""
STAGE_MARKS = ("  tables_async(smem, tid);", "  // -- K2, pass 1", "  // -- K2, pass 2",
               "  // -- K3: matrixing", "  fir_to_pcm<kThreads", "  write_fifo<kThreads",
               "  if (nv == 0 && t0 == 0) {\n    for (int k = tid; k < kSubFloats;")
STAGES = ("K1", "K2 pass 1", "K2 pass 2", "matrixing", "FIR", "FIFO")
K1_MARKS = ("  // -- A: every load of the tile", "  // each item's band indices",
            "  // -- B: per-band values and ginfo", "  // -- C: kSpan lines x 2")
K1_STEPS = ("tables issued", "A: loads", "band maps", "B: per-band values", "C: lines")


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"chain_probe: {old!r} not found; update the probe")
    return text.replace(old, new, 1)


def variants() -> dict:
    """name -> (chain.cu text, {header name: text} overrides)."""
    src = (CSRC / "chain.cu").read_text()

    def cut(mark):
        return _sub(src, mark, "return;\n" + mark)

    synth = (CSRC / "synth_tile.cuh").read_text()
    head, sym = synth.split("template <int kVStride>\n__device__ __forceinline__ void "
                            "matrix_tile_sym", 1)
    for old, new in (("float acc[3][2][4] = {};", "float acc[2][2][4] = {};"),
                     ("for (int q = 0; q < 3; q++) {", "for (int q = 0; q < 2; q++) {"),
                     ("pg + 6 * q", "pg + 9 * q"), ("pg + 6 * q", "pg + 9 * q"),
                     ("for (int q = 0; q < 3; q++) {", "for (int q = 0; q < 2; q++) {")):
        sym = _sub(sym, old, new)
    tile2 = _sub(head, "constexpr int kSymTile = 54;", "constexpr int kSymTile = 81;") + \
        "template <int kVStride>\n__device__ __forceinline__ void matrix_tile_sym" + sym
    stamped = _sub(src, '#include "device_guard.cuh"', STAMP_HEAD + '#include "device_guard.cuh"')
    for i, mark in enumerate(STAGE_MARKS):
        stamped = _sub(stamped, mark, f"  STAMP({i});\n" + mark)
    stamped += ('\nextern "C" int get_stamps(void* dst, size_t n) {\n'
                '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n')
    requant = (CSRC / "requant_tile.cuh").read_text()
    for i, mark in enumerate(K1_MARKS):
        requant = _sub(requant, mark, f"  STAMP({8 + i});\n" + mark)
    return {
        "base": (src, {}),
        "k1_only": (cut("  // -- K2, pass 1"), {}),
        "k1_k2": (cut("  // -- K3: matrixing"), {}),
        "no_fir": (cut("  fir_to_pcm<kThreads"), {}),
        "t384": (_sub(src, "constexpr int kThreads = 512;", "constexpr int kThreads = 384;"), {}),
        "tile2": (src, {"synth_tile.cuh": tile2}),
        "stamped": (stamped, {"requant_tile.cuh": requant}),
    }


def build(name: str, text: str, headers: dict):
    from go_mp3_tpu_torch.ops import _build

    inc = OUT / name
    inc.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        (inc / f.name).write_text(headers.get(f.name, f.read_text()))
    (inc / "chain.cu").write_text(text)
    lib = inc / "libchain.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(lib),
                           str(inc / "chain.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc {name}:\n{proc.stderr[-3000:]}")
    regs = next((ln.split("info    :")[-1].strip() for ln in proc.stderr.splitlines()
                 if "registers" in ln), "")
    return lib, regs


def main() -> int:
    import torch

    import chip_smoke as cs
    from go_mp3_tpu_torch.ops import kernels as K
    from go_mp3_tpu_torch.ops import tables as T
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    if not torch.cuda.is_available():
        print("chain_probe: CUDA is not available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(variants(), pool.map(lambda kv: build(kv[0], *kv[1]),
                                              variants().items())))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    K._library(dev)
    tables = [np.ascontiguousarray(T.PRETAB, np.float32), T.IS_RATIO_L, T.IS_RATIO_R,
              np.ascontiguousarray(T.LONG_BAND_START[:, :22], np.int32),
              np.ascontiguousarray(T.SHORT_BAND_START3[:, :13], np.int32),
              T.LONG_SFB_OF_LINE.astype(np.uint8),
              (T.REQ_SHORT_SFB_OF_LINE * 3 + T.REQ_SHORT_WIN_OF_LINE).astype(np.uint8),
              (T.SHORT_SFB_OF_LINE * 3 + T.SHORT_WIN_OF_LINE).astype(np.uint8),
              T.CS, T.CA, T.COS_N36, T.SHORT_M3, T.IMDCT_WIN,
              np.ascontiguousarray(T.SYNTH_N_WIN.T), T.SYNTH_DTBL]
    inputs = cs.k1_inputs(cs.SEED + 60, S_DIM, T_DIM, LINES, False, dev)
    rng = np.random.default_rng(cs.SEED + 61)
    state = state_from_numpy(
        (rng.standard_normal((S_DIM, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((S_DIM, 2, 16, 64)) * 0.3).astype(np.float32), dev)
    valid = torch.from_numpy(rng.integers(1, T_DIM + 1, S_DIM).astype(np.int32)).to(dev)
    want = {lab: cs.k123(inputs[lab], T_DIM, state, valid, LINES) for lab in ("int8", "fused")}
    p, i = ctypes.c_void_p, ctypes.c_int
    package_library = K._library
    try:
        for name, (path, regs) in built.items():
            lib = ctypes.CDLL(str(path))
            lib.gomp3_chain_init.argtypes = [i] + [p] * 15
            lib.gomp3_chain.argtypes = [i, i, ctypes.POINTER(p), p, p, p, p, p, p,
                                        i, i, i, i, i, p]
            if lib.gomp3_chain_init(0, *(a.ctypes.data for a in tables)):
                raise SystemExit(f"{name}: chain_init failed")
            K._library = lambda dev, lib=lib: (lib, 0)
            cells = []
            for lab in ("int8", "fused"):
                def run(lab=lab):
                    return cs._chain_launch(lab, inputs[lab], S_DIM, T_DIM, state, valid, G,
                                            LINES, False)
                same = all(torch.equal(a, b) for a, b in zip(run(), want[lab]))
                cells.append(f"{lab} {cs.time_ms(run):.4f} ms"
                             f"{'' if same else ' (output differs)'}")
            print(f"{name:8s} {'; '.join(cells)}  [{regs}]", flush=True)
            if name == "stamped":
                report_stamps(lib, lambda: cs._chain_launch(
                    "int8", inputs["int8"], S_DIM, T_DIM, state, valid, G, LINES, False))
    finally:
        K._library = package_library
    return 0


def report_stamps(lib, run) -> None:
    import torch

    run()
    torch.cuda.synchronize()
    st = np.zeros((16384, 16), np.int64)
    lib_get = getattr(lib, "get_stamps", None)
    if lib_get is None:
        raise SystemExit("stamped: no get_stamps")
    lib_get.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib_get(st.ctypes.data, st.nbytes)
    st = st[:S_DIM * -(-T_DIM // G)]
    stage = np.diff(st[:, :7], axis=1)
    k1 = np.diff(np.concatenate([st[:, :1], st[:, 8:12], st[:, 1:2]], axis=1), axis=1)
    total = (st[:, 6] - st[:, 0]).mean()
    print(f"  cycles a block (mean over {len(st)} blocks, int8 input; p10-p90), "
          f"total {total:.0f}:")
    for name, col in list(zip(STAGES, stage.T)) + [(f"K1 {n}", c) for n, c in zip(K1_STEPS, k1.T)]:
        print(f"    {name:22s} {col.mean():8.0f} ({np.percentile(col, 10):.0f}-"
              f"{np.percentile(col, 90):.0f}), {100 * col.mean() / total:.1f}%")
    per_sm = np.bincount(st[:, 15].astype(np.int64))
    print(f"  blocks per SM: {per_sm.min()}-{per_sm.max()}")


if __name__ == "__main__":
    sys.exit(main())
