"""Where the chain kernel's time goes, on one GPU: variants of
go_mp3_tpu_torch/csrc/chain.cu built beside the package's library, each
timed at [64, 240] on the int8 input and the fused wire at the wrapper's
(G, L) (chip_smoke.py's timer, inputs and K1 -> K2 -> K3 reference);
base and walk1 also at L = 1 on the int8 input at [64, 240], [64, 37]
and [1, 128], G as the wrapper picks it.

    python3 tests/chain_probe.py [VARIANT ...]   (default: all)

Variants (the text of the sources changed, nothing else):
  base       the source as it is (L = 1: the one-run-a-block kernel);
  walk1      L = 1 launched as a segment walk of one run (the halo's
             steps, then the run's, K1 in its own warps) instead;
  serial     the two groups with no overlap: the K1 group waits until the
             K2/K3 group has finished a run before it loads the next;
  k23_192, k23_224, k23_320, k23_384
             192 .. 384 of the 512 threads on K2/K3 (320 .. 128 on K1)
             instead of 256;
  lb1        the segment walk launched as one block an SM (128 registers a
             thread, no spills) instead of two;
  stamped    clock64() per block and run: the K1 group's first thread at
             the start and end of each run's K1 and around its wait for x,
             the K2/K3 group's thread 0 at each stage boundary: cycles a
             run of K1 (its wait for x left out), K2 pass 1 and pass 2,
             the matrixing and the FIR (mean over the runs after each
             segment's halo), the K2/K3 group's wait for each run, and the
             share of K1's cycles that ran while the K2/K3 group was busy
             (hidden under K2/K3).
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
S_DIM, T_DIM, LINES = 64, 240, 512
L1_SHAPES = ((64, 37), (1, 128))  # timed at L = 1 beside [64, 240] (base, walk1)
L1_REPS = 3  # timings of each, for their spread
MAX_BLOCKS, MAX_STEPS = 8192, 64

STAMP_HEAD = f"""
__device__ long long g_stamps[{MAX_BLOCKS}][{MAX_STEPS}][12];
#define STAMP(k, i) do {{ const int b_ = blockIdx.y * gridDim.x + blockIdx.x;           \\
    if (b_ < {MAX_BLOCKS} && (k) < {MAX_STEPS}) g_stamps[b_][k][i] = clock64(); }} while (0)
#define PSTAMP(k, i) do {{ if (threadIdx.x == kK23) STAMP(k, i); }} while (0)
#define CSTAMP(k, i) do {{ if (threadIdx.x == 0) STAMP(k, i); }} while (0)
"""
# stamp slots: K1 group 0 start, 1 end, 2-3 around its wait for x;
# K2/K3 group 4 start (x ready), 5 pass 1 done, 6 pass 2 start, 7 matrixing
# start, 8 FIR start, 9 FIR and FIFO done
CONSUMER_MARKS = (("  // -- K2, pass 1:", 4), ("  after_pass1(more);", 5),
                  ("  // -- K2, pass 2:", 6), ("  // -- K3 ---", 7),
                  ("  fir_to_pcm<kN, kVStride>", 8),
                  ("  if (more) {  // the run's last 15 v rows", 9))


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"chain_probe: {old!r} not found; update the probe")
    return text.replace(old, new, 1)


def variants() -> dict:
    """name -> chain.cu text."""
    src = (CSRC / "chain.cu").read_text()
    serial = _sub(src, "    if (more) gomp3::bar_arrive(kBarEmpty, kThreads);",
                  "    (void)more;")
    serial = _sub(serial, "  if (more) {  // the run's last 15 v rows",
                  "  if (more) gomp3::bar_arrive(kBarEmpty, kThreads);\n"
                  "  if (more) {  // the run's last 15 v rows")
    serial = _sub(serial, "    return;  // the next step's barriers",
                  "    if (more) gomp3::bar_arrive(kBarEmpty, kThreads);\n"
                  "    return;  // the next step's barriers")
    serial = _sub(serial, "      if (k > 0) gomp3::bar_sync(kBarK1, kK1);",
                  "      if (k > 0) gomp3::bar_sync(kBarEmpty, kThreads);")
    serial = _sub(serial, "WaitForX{k > 0}", "WaitForX{false}")
    stamped = _sub(src, '#include "barrier.cuh"', STAMP_HEAD + '#include "barrier.cuh"')
    stamped = _sub(stamped, "struct WaitForX {\n  bool wait;",
                   "struct WaitForX {\n  bool wait;\n  int k;")
    stamped = _sub(stamped, "    if (wait) gomp3::bar_sync(kBarEmpty, kThreads);",
                   "    PSTAMP(k, 2);\n    if (wait) gomp3::bar_sync(kBarEmpty, kThreads);\n"
                   "    PSTAMP(k, 3);")
    stamped = _sub(stamped, "WaitForX{k > 0}", "WaitForX{k > 0, k}")
    stamped = _sub(stamped, "      k1_step<kLayout, G, kK1>(",
                   "      PSTAMP(k, 0);\n      k1_step<kLayout, G, kK1>(")
    stamped = _sub(stamped, "      gomp3::bar_arrive(kBarFull, kThreads);",
                   "      PSTAMP(k, 1);\n      gomp3::bar_arrive(kBarFull, kThreads);")
    for mark, i in CONSUMER_MARKS:
        stamped = _sub(stamped, mark, f"  CSTAMP(k, {i});\n" + mark)
    stamped += ('\nextern "C" int get_stamps(void* dst, size_t n) {\n'
                '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n);\n}\n')
    split = {f"k23_{n}": _sub(src, "constexpr int kK23 = 256;", f"constexpr int kK23 = {n};")
             for n in (192, 224, 320, 384)}
    lb1 = _sub(src, "__global__ void __launch_bounds__(kThreads, 2)\nchain_kernel(",
               "__global__ void __launch_bounds__(kThreads, 1)\nchain_kernel(")
    walk1 = _sub(src, "  if (L == 1) {\n    const size_t bytes = run_smem_bytes<G>();",
                 "  if (false) {\n    const size_t bytes = run_smem_bytes<G>();")
    return {"base": src, "walk1": walk1, "serial": serial, **split, "lb1": lb1,
            "stamped": stamped}


def build(name: str, text: str):
    from go_mp3_tpu_torch.ops import _build

    inc = OUT / name
    inc.mkdir(parents=True, exist_ok=True)
    for f in CSRC.glob("*.cuh"):
        (inc / f.name).write_text(f.read_text())
    (inc / "chain.cu").write_text(text)
    lib = inc / "libchain.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(lib),
                           str(inc / "chain.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc {name}:\n{proc.stderr[-3000:]}")
    regs = sorted({ln.split("info    :")[-1].strip() for ln in proc.stderr.splitlines()
                   if "registers" in ln})
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
    todo = {k: v for k, v in variants().items() if k in (sys.argv[1:] or [k])}
    with ThreadPoolExecutor(8) as pool:
        built = dict(zip(todo, pool.map(lambda kv: build(*kv), todo.items())))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    K._library(dev)
    pick = K.chain_run(dev, S_DIM, T_DIM)
    tables = [np.ascontiguousarray(T.PRETAB, np.float32), T.IS_RATIO_L, T.IS_RATIO_R,
              np.ascontiguousarray(T.LONG_BAND_START[:, :22], np.int32),
              np.ascontiguousarray(T.SHORT_BAND_START3[:, :13], np.int32),
              T.LONG_SFB_OF_LINE.astype(np.uint8),
              (T.REQ_SHORT_SFB_OF_LINE * 3 + T.REQ_SHORT_WIN_OF_LINE).astype(np.uint8),
              (T.SHORT_SFB_OF_LINE * 3 + T.SHORT_WIN_OF_LINE).astype(np.uint8),
              T.CS, T.CA, T.COS_N36, T.SHORT_M3, T.IMDCT_WIN,
              np.ascontiguousarray(T.SYNTH_N_WIN.T), T.SYNTH_DTBL]
    shapes = {}  # (S, T) -> inputs, state, valid, K1 -> K2 -> K3's result by input
    for k, (s_dim, t_dim) in enumerate(((S_DIM, T_DIM), *L1_SHAPES)):
        inputs = cs.k1_inputs(cs.SEED + 60 + 2 * k, s_dim, t_dim, LINES, False, dev)
        rng = np.random.default_rng(cs.SEED + 61 + 2 * k)
        state = state_from_numpy(
            (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), dev)
        valid = torch.from_numpy(rng.integers(1, t_dim + 1, s_dim).astype(np.int32)).to(dev)
        want = {lab: cs.k123(inputs[lab], t_dim, state, valid, LINES)
                for lab in ("int8", "fused")}
        shapes[(s_dim, t_dim)] = inputs, state, valid, want
    inputs, state, valid, want = shapes[(S_DIM, T_DIM)]
    p, i = ctypes.c_void_p, ctypes.c_int
    package_library = K._library
    print(f"[64, 240], the wrapper's (G, L) = {pick}")
    try:
        for name, (path, regs) in built.items():
            lib = ctypes.CDLL(str(path))
            lib.gomp3_chain_init.argtypes = [i] + [p] * 15
            lib.gomp3_chain.argtypes = [i, i, ctypes.POINTER(p), p, p, p, p, p, p,
                                        i, i, i, i, i, i, p]
            if lib.gomp3_chain_init(0, *(a.ctypes.data for a in tables)):
                raise SystemExit(f"{name}: chain_init failed")
            K._library = lambda dev, lib=lib: (lib, 0)
            cells = []
            for lab in ("int8", "fused"):
                def run(lab=lab):
                    return cs._chain_launch(lab, inputs[lab], S_DIM, T_DIM, state, valid,
                                            *pick, LINES, False)
                same = all(torch.equal(a, b) for a, b in zip(run(), want[lab]))
                cells.append(f"{lab} {cs.time_ms(run):.4f} ms{'' if same else ' (output differs)'}")
            for (s_dim, t_dim), (ins, st, v, ref) in shapes.items():
                if name not in ("base", "walk1"):
                    break
                g = K.chain_run(dev, s_dim, t_dim)[0]

                def run1(s_dim=s_dim, t_dim=t_dim, ins=ins, st=st, v=v, g=g):
                    return cs._chain_launch("int8", ins["int8"], s_dim, t_dim, st, v, g, 1,
                                            LINES, False)
                same = all(torch.equal(a, b) for a, b in zip(run1(), ref["int8"]))
                reps = [cs.time_ms(run1) for _ in range(L1_REPS)]
                cells.append(f"int8 [{s_dim}, {t_dim}] G={g} L=1 "
                             f"{', '.join(f'{t:.4f}' for t in reps)} ms"
                             f"{'' if same else ' (output differs)'}")
            print(f"{name:8s} {'; '.join(cells)}  {regs}", flush=True)
            if name == "stamped":
                report_stamps(lib, pick, lambda: cs._chain_launch(
                    "int8", inputs["int8"], S_DIM, T_DIM, state, valid, *pick, LINES, False))
    finally:
        K._library = package_library
    return 0


def _overlap(a0, a1, b0, b1) -> np.ndarray:
    return np.clip(np.minimum(a1, b1) - np.maximum(a0, b0), 0, None)


def report_stamps(lib, pick, run) -> None:
    import torch

    g, n_runs = pick
    run()
    torch.cuda.synchronize()
    st = np.zeros((MAX_BLOCKS, MAX_STEPS, 12), np.int64)
    lib.get_stamps.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.get_stamps(st.ctypes.data, st.nbytes)
    segs = -(-T_DIM // (g * n_runs))
    st = st[:S_DIM * segs]
    rows = {"K1 (its wait for x left out)": [], "K1's wait for x": [], "K2 pass 1": [],
            "K2 pass 2": [], "matrixing": [], "FIR": [], "K2/K3 wait for x": []}
    hidden, k1_all, per_run = 0, 0, []
    for b in range(len(st)):
        t0 = (b % segs) * g * n_runs
        nh = -(-min(t0, 2) // g)
        nsteps = nh + -(-(min(t0 + g * n_runs, T_DIM) - t0) // g)
        s = st[b, :nsteps]
        busy = [(s[k, 4], s[k, 9] if k >= nh else s[k, 7]) for k in range(nsteps)]
        for k in range(nh, nsteps):
            k1 = s[k, 1] - s[k, 0] - (s[k, 3] - s[k, 2])
            rows["K1 (its wait for x left out)"].append(k1)
            rows["K1's wait for x"].append(s[k, 3] - s[k, 2])
            rows["K2 pass 1"].append(s[k, 5] - s[k, 4])
            rows["K2 pass 2"].append(s[k, 7] - s[k, 6])
            rows["matrixing"].append(s[k, 8] - s[k, 7])
            rows["FIR"].append(s[k, 9] - s[k, 8])
            if k:
                rows["K2/K3 wait for x"].append(s[k, 4] - busy[k - 1][1])
            # K1's own cycles (its two intervals around the wait) that ran
            # while the K2/K3 group worked on an earlier run
            for a0, a1 in ((s[k, 0], s[k, 2]), (s[k, 3], s[k, 1])):
                hidden += sum(int(_overlap(a0, a1, c0, c1)) for c0, c1 in busy[:k])
            k1_all += k1
        per_run.append((s[nsteps - 1, 9] - s[0, 0]) / (nsteps - nh))
    print(f"  cycles a run (mean over {len(st)} blocks' runs after the halo, int8 input; "
          f"p10-p90); a block {np.mean([r * 1 for r in per_run]):.0f} cycles a run "
          f"from its first K1 to its last FIR:")
    for name, col in rows.items():
        col = np.asarray(col, np.float64)
        print(f"    {name:30s} {col.mean():8.0f} ({np.percentile(col, 10):.0f}-"
              f"{np.percentile(col, 90):.0f})")
    print(f"  K1 hidden under K2/K3: {100 * hidden / max(k1_all, 1):.1f}% of K1's cycles")


if __name__ == "__main__":
    sys.exit(main())
