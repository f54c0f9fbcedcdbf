"""Build the port's CUDA kernels from go_mp3_tpu_torch/csrc at first use.

nvcc compiles every csrc/*.cu for sm_90a (one process per source, run
side by side) and links them into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds). The library lands in build/go_mp3_tpu_torch/<hash>/ at the repo
root, keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import.

No --use_fast_math: the kernels need the accurate exp2f/log2f and
denormals kept, for the 2e-5 requantize bound and tiny-exponent lines.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "go_mp3_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_LINK_FLAGS = ["-shared"]  # nvcc's default static cudart
_LIB_NAME = "libgomp3_kernels.so"

_lib = None
build_seconds = 0.0  # wall time of the build this process ran (0 if cached)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    """Keyed by the flags and every source and header in csrc/."""
    h = hashlib.sha256(" ".join(_FLAGS + _LINK_FLAGS).encode())
    for src in sorted(_sources() + list(_CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def _build(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, errors = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        log.append(" ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]} ({proc.returncode}):\n{stderr[-4000:]}")
    tmp = out.with_name(f"{out.name}.{tag}.tmp")
    if not errors:
        cmd = [nvcc, *_LINK_FLAGS, "-o", str(tmp), *(str(j[1]) for j in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            errors.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    build_seconds = time.perf_counter() - t0
    (out.parent / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if errors:
        raise RuntimeError("nvcc failed: " + "\n".join(errors))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def load():
    """The kernel library (built on first call), with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _build(path)
    _lib = bind(ctypes.CDLL(str(path)), SIGNATURES)
    return _lib


_p, _i, _pp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
SIGNATURES = {  # C entry point -> argtypes; every one returns a CUDA error code
    "gomp3_requant_stereo_init": [_i] + [_p] * 8,
    "gomp3_requant_stereo": [_i, _i, _pp, _p, _p, _i, _i, _i, _i, _i, _i, _p],
    "gomp3_hybrid_init": [_i] + [_p] * 5,
    "gomp3_hybrid": [_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _p],
    "gomp3_synth_init": [_i, _p, _p],
    "gomp3_synth": [_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "gomp3_unpack_fused": [_i, _p, _p, _p, _p, _i, _i, _i, _i, _p],
    "gomp3_chain_init": [_i] + [_p] * 15,
    "gomp3_chain": [_i, _i, _pp, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
    "gomp3_energy": [_i, _p, _p, _i, ctypes.c_longlong, _p],
}


def bind(lib, names):
    """Set argtypes and restype of each entry point in `names` on `lib`."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib
