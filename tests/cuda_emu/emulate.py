"""Run the port's CUDA kernels on a CPU, emulated, to rehearse a kernel
change before a GPU run.

    python tests/cuda_emu/emulate.py [--kernels chain,energy] [--inputs int8,fused]
                                     [--quick] [--mutate FILE OLD NEW] [--build-dir DIR]

Builds go_mp3_tpu_torch/csrc/*.cu with g++ against cuda_runtime.h beside
this file (one OS thread per CUDA thread, real barriers, named barriers
included, dynamic shared memory filled with NaN) into build/cuda_emu/,
points the kernel wrappers' CUDA route at that library for CPU tensors,
and holds the chain kernel (K5) bit for bit against K1 -> K2 -> K3
through their own wrappers on small seeded chunks (stereo and mono, valid
0, T and ragged), on each of K1's four inputs, at every G with segments of
L = 1, 2, 3 runs and one segment a stream (so across segment edges); K1 ->
K2 -> K3 is also measured against the plain chain. --quick checks the first chunk only, at
G = 2. It holds the energy kernel (energy.cu) bit for bit against its
plain version energy_ref on seeded PCM (-32768 included, a row whose sum
wraps past 2^31, rows of one word and of none). --kernels energy builds
energy.cu alone (seconds) and checks only it. Exit status 1 on any
difference.

It checks indexing, halos, barriers (a named barrier used with two
counts, or left with a phase open at a block's end, aborts) and the
order of operations, not speed, and not the card's bits: exp2f/log2f are
the C library's. --mutate replaces the text OLD by NEW in one source
before the build, for a negative control: a halo of one granule must
differ (--mutate chain.cu "kHalo = 2;" "kHalo = 1;"), and so must a
segment whose runs do not hand on their upper halves or their v rows
(tests/test_torch_chain.py EMU_MUTANTS), and an energy that drops the last
word of each row (--mutate energy.cu "i < words ?" "i < words - 1 ?").
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
CSRC = ROOT / "go_mp3_tpu_torch" / "csrc"
OUT = ROOT / "build" / "cuda_emu"
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from go_mp3_tpu_torch.ops import _build  # noqa: E402
from go_mp3_tpu_torch.ops import granule as G  # noqa: E402
from go_mp3_tpu_torch.ops import kernels as K  # noqa: E402

LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?),(.*?),(.*?),(.*?)>>>\s*\((.*?)\);", re.S)
CASES = (  # S, T, wire tail lines, mono, valid vectors
    (2, 9, 512, False, ([0, 9], [9, 5], [1, 2])),
    (3, 13, 301, True, ([0, 13, 6],)),
    (1, 1, 512, False, ([0], [1])),
    (1, 6, 464, False, ([6], [4], [3])),
)


ENERGY_CASES = (  # S, samples a channel, fill: "random" (seeded, -32768 set) or "wrap"
    (3, 1152, "random"),
    (1, 240 * 576, "wrap"),
    (2, 4, "random"),
    (2, 0, "random"),
)


def build(mutate=None, out: Path = OUT, sources=None) -> Path:
    """csrc/*.cu (or the files named in `sources`), launches rewritten for
    the emulation -> libemu.so."""
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    if mutate:
        path, old, new = src / mutate[0], mutate[1], mutate[2]
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"--mutate: {old!r} not in {mutate[0]}")
        path.write_text(text.replace(old, new))
    for cu in src.glob("*.cu"):
        text = LAUNCH.sub(r"emu_launch(dim3(\2), dim3(\3), \4, [=] { \1(\6); });",
                          cu.read_text())
        cu.write_text(text.replace("extern __shared__ __align__(16) float smem[];",
                                   "float* smem = emu_dyn_smem;"))
    flags = ["-std=c++20", "-O1", "-ffp-contract=off", "-fPIC", f"-I{HERE}", "-x", "c++"]

    def compile_one(cu: Path):
        obj = cu.with_suffix(".o")
        p = subprocess.run(["g++", *flags, "-c", str(cu), "-o", str(obj)],
                           capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"g++ {cu.name}:\n{p.stderr[-4000:]}")
        return obj

    cus = sorted(src.glob("*.cu")) if sources is None else [src / n for n in sources]
    with ThreadPoolExecutor(8) as pool:
        objs = list(pool.map(compile_one, cus))
    lib = out / "libemu.so"
    subprocess.run(["g++", "-shared", "-o", str(lib), *map(str, objs), "-lpthread"], check=True)
    return lib


def segments(t_dim: int, quick: bool = False) -> list[tuple[int, int]]:
    """(G, L) of every chain launch on one chunk: chip_smoke's segment cover
    (every G at L = 1, 2, 3 and one segment a stream); quick: G = 2 only."""
    import chip_smoke as cs

    return [(g, n) for g, n in cs.chain_segments(t_dim) if not quick or g == 2]


def check_chain(labels, quick: bool = False) -> tuple[int, int]:
    """The chain against K1 -> K2 -> K3 on CASES (quick: the first, at
    G = 2) -> (differences, checks)."""
    import chip_smoke as cs

    dev, diffs, checks = torch.device("cpu"), 0, 0
    for i, (s_dim, t_dim, lines, mono, valids) in enumerate(CASES[:1] if quick else CASES):
        rng = np.random.default_rng(5 + i)
        inputs = cs.k1_inputs(5 + i, s_dim, t_dim, lines, mono, dev)
        state = G.state_from_numpy(
            (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), dev)
        batch = cs.k1_batch(inputs["fused"], t_dim, lines, mono)
        for v in valids:
            valid = torch.tensor(v, dtype=torch.int32)
            for label in labels:
                packed = inputs[label]
                want = cs.k123(packed, t_dim, state, valid, lines, mono)
                for g, runs in segments(t_dim, quick):
                    got = cs._chain_launch(label, packed, s_dim, t_dim, state, valid, g, runs,
                                           lines, mono)
                    bad = [n for n, a, b in zip(("pcm", "store", "fifo"), got, want)
                           if not torch.equal(a, b)]
                    checks += 1
                    diffs += bool(bad)
                    if bad:
                        print(f"S={s_dim} T={t_dim} mono={mono} valid={v} [{label}] G={g} "
                              f"L={runs}: {', '.join(bad)} differ from "
                              f"K1 -> K2 -> K3", flush=True)
            ref_pcm, ref_st = G.decode_chunk_ref(batch, state, valid)
            d = int((want[0].int() - ref_pcm.int()).abs().max())
            print(f"S={s_dim} T={t_dim} mono={mono} valid={v}: K1 -> K2 -> K3 against the "
                  f"plain chain: PCM max {d} LSB", flush=True)
    print(f"{checks - diffs} of {checks} chain launches bit-identical to K1 -> K2 -> K3")
    return diffs, checks


def energy_input(seed: int, s_dim: int, n: int, fill: str) -> torch.Tensor:
    """Seeded int16 PCM [S, n, 2]: "random" over the full range with the
    first sample -32768, or "wrap": -32768 but for a few seeded samples, so
    that each row's sum passes 2^31 and wraps."""
    rng = np.random.default_rng(seed)
    if fill == "wrap":
        a = np.full((s_dim, n, 2), -32768, np.int16)
        a.reshape(-1)[rng.integers(0, a.size, 64)] = rng.integers(-32768, 32768, 64)
    else:
        a = rng.integers(-32768, 32768, (s_dim, n, 2)).astype(np.int16)
        a.reshape(-1)[:1] = -32768
    return torch.from_numpy(a)


def check_energy() -> tuple[int, int]:
    """The energy kernel against energy_ref on ENERGY_CASES -> (differences,
    checks)."""
    diffs = 0
    for i, (s_dim, n, fill) in enumerate(ENERGY_CASES):
        pcm = energy_input(40 + i, s_dim, n, fill)
        got, want = K.energy(pcm), G.energy_ref(pcm)
        exact = pcm.to(torch.int64).abs().sum(dim=(1, 2))
        same = torch.equal(got, want)
        diffs += not same
        print(f"energy S={s_dim} N={n} [{fill}]: {'bit-identical to' if same else 'DIFFERS from'} "
              f"energy_ref (kernel {got.tolist()}, plain {want.tolist()}; unwrapped sums "
              f"{exact.tolist()})", flush=True)
    print(f"{len(ENERGY_CASES) - diffs} of {len(ENERGY_CASES)} energy cases bit-identical")
    return diffs, len(ENERGY_CASES)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="chain,energy",
                    help="kernels to check, comma-separated: chain, energy")
    ap.add_argument("--inputs", default="int8,int16,granule_batch,fused",
                    help="K1's inputs to check the chain on, comma-separated")
    ap.add_argument("--quick", action="store_true",
                    help="the chain on the first case only, at G = 2 (L = 1, 2, 3, 5)")
    ap.add_argument("--mutate", nargs=3, metavar=("FILE", "OLD", "NEW"))
    ap.add_argument("--build-dir", type=Path, default=OUT)
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    chain = "chain" in kernels
    lib = build(args.mutate, args.build_dir, None if chain else ["energy.cu"])
    # the wrappers' CUDA route, on CPU tensors, through the emulated library
    if chain:
        _build.library_path = lambda: lib
    else:  # energy.cu alone: no tables to upload
        _build._lib = _build.bind(ctypes.CDLL(str(lib)), ["gomp3_energy"])
        K._ready_devices.add(0)
    K._route = lambda dev: True
    K._sm_count = lambda dev: 132
    torch.cuda.current_device = lambda: 0
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)

    diffs = 0
    if chain:
        diffs += check_chain(args.inputs.split(","), args.quick)[0]
    if "energy" in kernels:
        diffs += check_energy()[0]
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
