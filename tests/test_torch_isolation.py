"""The port stays JAX-free, imports without a CUDA toolchain, and routes
CPU tensors to the plain versions without touching the kernel library."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_mp3_tpu_torch.ops import _build, kernels, wire  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
import torch_synthetic as syn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODULES = [
    "go_mp3_tpu_torch",
    "go_mp3_tpu_torch.conformance",
    "go_mp3_tpu_torch.decoder",
    "go_mp3_tpu_torch.device",
    "go_mp3_tpu_torch.gapless",
    "go_mp3_tpu_torch.golden",
    "go_mp3_tpu_torch.models",
    "go_mp3_tpu_torch.models.native_pipeline",
    "go_mp3_tpu_torch.models.pipeline",
    "go_mp3_tpu_torch.ops",
    "go_mp3_tpu_torch.ops._build",
    "go_mp3_tpu_torch.ops.granule",
    "go_mp3_tpu_torch.ops.kernels",
    "go_mp3_tpu_torch.ops.tables",
    "go_mp3_tpu_torch.ops.wire",
    "go_mp3_tpu_torch.parallel",
    "go_mp3_tpu_torch.parallel.corpus",
    "go_mp3_tpu_torch.parallel.mesh",
    "go_mp3_tpu_torch.parallel.segment",
    "go_mp3_tpu_torch.reference",
]


def _run(code: str, **env_extra) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT), **env_extra}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_every_module_imports_without_jax():
    pkg = ROOT / "go_mp3_tpu_torch"
    found = {
        "go_mp3_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py")
    }
    found = {m.removesuffix(".__init__") for m in found}
    assert found == set(MODULES), "update MODULES"
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from go_mp3_tpu_torch.golden import golden_decoder_class\n"
        "golden_decoder_class()()  # the oracle loaded, as Decoder(backend='golden') does\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "assert not [m for m in sys.modules if m.startswith(\n"
        "    ('go_mp3_tpu.ops', 'go_mp3_tpu.models', 'go_mp3_tpu.parallel'))]\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_kernels_import_without_nvcc_or_triton(tmp_path):
    """No toolchain on PATH: importing and the CPU path still work; only
    a CUDA launch needs nvcc (and then the build raises)."""
    code = (
        "import shutil, sys, torch\n"
        "assert shutil.which('nvcc') is None\n"
        "from go_mp3_tpu_torch.ops import kernels\n"
        "assert 'triton' not in sys.modules\n"
        "x = torch.zeros((1, 2, 2, 576)); g = torch.zeros((1, 2), dtype=torch.int32)\n"
        "st = torch.zeros((1, 2, 32, 18)); v = torch.tensor([2], dtype=torch.int32)\n"
        "kernels.hybrid(x, g, st, v)\n"
        "assert kernels.launch_counts()['hybrid'] == 0\n"
        "print('ok')\n"
    )
    proc = _run(code, PATH=str(tmp_path))
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


@pytest.mark.parametrize(
    "name", ["requant_stereo", "requant_stereo_batch", "hybrid", "synth", "unpack_fused"])
def test_cpu_tensors_route_to_plain_version(name, monkeypatch):
    """A wrapper given CPU tensors returns the plain version's result and
    counts no launch; the kernel library is never loaded."""
    def no_build():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    valid = np.array([20, 7])
    packed = tuple(map(torch.from_numpy, syn.random_chunk(6, 2, 20, valid)))
    v = torch.tensor(valid, dtype=torch.int32)
    state = P.init_state(2, "cpu")
    batch = P.GranuleBatch(*(f.contiguous() for f in P.batch_from_packed(*packed)))
    x, ginfo = P.requant_stereo_ref(P.batch_from_packed(*packed))
    x18, _ = P.hybrid_ref(x, ginfo, state.store, v)
    buf = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, wire.fused_stream_nbytes(20, 301)), dtype=np.uint8))
    args = {
        "requant_stereo": ((packed,), (x, ginfo)),
        "requant_stereo_batch": ((batch,), (x, ginfo)),
        "hybrid": ((x, ginfo, state.store, v), P.hybrid_ref(x, ginfo, state.store, v)),
        "synth": ((x18, ginfo, state.v_fifo, v), P.synth_ref(x18, ginfo, state.v_fifo, v)),
        "unpack_fused": ((buf, 20, 301), P.unpack_fused_ref(buf, 20, 301)),
    }[name]
    kernels.reset_launch_counts()
    wrapper = name.removesuffix("_batch")
    got = getattr(kernels, wrapper)(*args[0])
    for a, b in zip(got, args[1]):
        assert torch.equal(a, b)
    assert kernels.launch_counts()[wrapper] == 0
    assert kernels.requant_stereo.batch_launches == 0


def test_wrapper_rejects_bad_input():
    x = torch.zeros((1, 2, 2, 576))
    g = torch.zeros((1, 2), dtype=torch.int32)
    st = torch.zeros((1, 2, 32, 18))
    with pytest.raises(TypeError):
        kernels.hybrid(x, g, st, torch.tensor([2]))  # int64 valid
    with pytest.raises(ValueError):
        kernels.hybrid(x, g, torch.zeros((1, 2, 32, 17)), torch.tensor([2], dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.requant_stereo((torch.zeros((1, 2, 1152), dtype=torch.int16),))


def test_build_is_keyed_by_sources():
    path = _build.library_path()
    assert path.parent.parent == ROOT / "build" / "go_mp3_tpu_torch"
    assert "--use_fast_math" not in _build._FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build._FLAGS
