"""The port stands alone: it imports nothing of jax and nothing of the JAX
package (no module, no file, no shared library of go_mp3_tpu/), imports
without a CUDA toolchain, and routes CPU tensors to the plain versions
without touching the kernel library."""

import ast
import json
import os
import re
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
    "go_mp3_tpu_torch.bench",
    "go_mp3_tpu_torch.bitstream",
    "go_mp3_tpu_torch.bitstream.bits",
    "go_mp3_tpu_torch.bitstream.frameheader",
    "go_mp3_tpu_torch.bitstream.huffman",
    "go_mp3_tpu_torch.bitstream.huffman_tables",
    "go_mp3_tpu_torch.bitstream.maindata",
    "go_mp3_tpu_torch.bitstream.parser",
    "go_mp3_tpu_torch.bitstream.sideinfo",
    "go_mp3_tpu_torch.bitstream.source",
    "go_mp3_tpu_torch.conformance",
    "go_mp3_tpu_torch.consts",
    "go_mp3_tpu_torch.decoder",
    "go_mp3_tpu_torch.device",
    "go_mp3_tpu_torch.gapless",
    "go_mp3_tpu_torch.golden",
    "go_mp3_tpu_torch.golden.reference_dsp",
    "go_mp3_tpu_torch.golden.synth_window_data",
    "go_mp3_tpu_torch.golden.tables",
    "go_mp3_tpu_torch.lameinfo",
    "go_mp3_tpu_torch.models",
    "go_mp3_tpu_torch.models.native_pipeline",
    "go_mp3_tpu_torch.models.pipeline",
    "go_mp3_tpu_torch.native",
    "go_mp3_tpu_torch.native.lib",
    "go_mp3_tpu_torch.ops",
    "go_mp3_tpu_torch.ops._build",
    "go_mp3_tpu_torch.ops.granule",
    "go_mp3_tpu_torch.ops.kernels",
    "go_mp3_tpu_torch.ops.tables",
    "go_mp3_tpu_torch.ops.wire",
    "go_mp3_tpu_torch.parallel",
    "go_mp3_tpu_torch.parallel.corpus",
    "go_mp3_tpu_torch.parallel.corpus_scan",
    "go_mp3_tpu_torch.parallel.mesh",
    "go_mp3_tpu_torch.parallel.segment",
    "go_mp3_tpu_torch.reference",
    "go_mp3_tpu_torch.spans",
    "go_mp3_tpu_torch.tools",
    "go_mp3_tpu_torch.tools.bench_compare",
    "go_mp3_tpu_torch.tools.bench_single",
    "go_mp3_tpu_torch.tools.cardtime",
    "go_mp3_tpu_torch.tools.compliance",
    "go_mp3_tpu_torch.tools.corpus",
    "go_mp3_tpu_torch.tools.example",
    "go_mp3_tpu_torch.tools.fuzz_soak",
    "go_mp3_tpu_torch.tools.parse_corpus_bench",
    "go_mp3_tpu_torch.tools.profile_decode",
    "go_mp3_tpu_torch.tools.profile_device",
    "go_mp3_tpu_torch.utils",
    "go_mp3_tpu_torch.utils.state",
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
        "from go_mp3_tpu_torch.golden import GoldenDecoder\n"
        "GoldenDecoder()  # the oracle, as Decoder(backend='golden') builds it\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr


def test_nothing_of_the_jax_package_is_loaded():
    """In a fresh process, after every port module, chip_smoke.py's own
    imports, a native parse and a decode on each backend: no module of
    go_mp3_tpu, no file under go_mp3_tpu/, and no libmp3parse.so mapped from
    there; the port's own library is mapped from its build directory."""
    code = (
        "import importlib, sys\n"
        "sys.path.insert(0, 'tests')\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import chip_smoke, torch_synthetic\n"
        "from go_mp3_tpu_torch import Decoder, GaplessDecoder, reference\n"
        "data = open('conformance/synthetic_escape.mp3', 'rb').read()\n"
        "reference.index_stream(data)\n"
        "for b in ('exact', 'golden'): Decoder(data, backend=b).read_all()\n"
        "Decoder(data, device='cpu').read_all()\n"
        "GaplessDecoder(data, device='cpu').read_all()\n"
        "import json\n"
        "print(json.dumps({\n"
        "    'modules': sorted(sys.modules),\n"
        "    'files': sorted(str(getattr(m, '__file__', None) or '')\n"
        "                    for m in list(sys.modules.values())),\n"
        "    'maps': open('/proc/self/maps').read().splitlines()}))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    seen = json.loads(proc.stdout.splitlines()[-1])
    jax_pkg = ROOT / "go_mp3_tpu"
    assert not [m for m in seen["modules"]
                if m == "go_mp3_tpu" or m.startswith("go_mp3_tpu.")]
    assert not [f for f in seen["files"] if f and Path(f).resolve().is_relative_to(jax_pkg)]
    libs = {ln.split()[-1] for ln in seen["maps"] if ln.endswith("libmp3parse.so")}
    assert libs, "the port's C++ parser was not loaded"
    for lib in libs:
        assert not Path(lib).resolve().is_relative_to(jax_pkg), lib
        assert Path(lib).resolve().is_relative_to(ROOT / "build" / "go_mp3_tpu_torch"), lib


# A string constant that names a place in the JAX package: a file:line
# reference in prose or a kernel row's "replaces" (go_mp3_tpu/ops/granule.py:361)
# is text, anything else could be a path the code builds.
_FILE_LINE = re.compile(r"^go_mp3_tpu/[\w/]+\.py:\d+$")
_JAX_PKG = re.compile(r"(^|[/\\\s'\"])go_mp3_tpu($|[/\\.\s'\"])")


def _docstrings(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            out.add(id(body[0].value))
    return out


def _sources() -> list:
    return [ROOT / "chip_smoke.py", *sorted((ROOT / "go_mp3_tpu_torch").rglob("*.py"))]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_and_builds_no_path_into_the_jax_package(path):
    """chip_smoke.py and every file of the port: no import of go_mp3_tpu
    (absolute, or relative past the package root), no name go_mp3_tpu, and
    no string that names the JAX package as a place, other than file:line
    references."""
    tree = ast.parse(path.read_text(), filename=str(path))
    depth = len(path.relative_to(ROOT).parts) - 1  # how far "from ..." may climb
    docs = _docstrings(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                assert a.name.split(".")[0] != "go_mp3_tpu", (path, node.lineno)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                assert (node.module or "").split(".")[0] != "go_mp3_tpu", (path, node.lineno)
            else:
                assert node.level <= depth, (path, node.lineno)
        elif isinstance(node, ast.Name):
            assert node.id != "go_mp3_tpu", (path, node.lineno)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            if id(node) in docs or _FILE_LINE.match(node.value):
                continue
            assert not _JAX_PKG.search(node.value), (path, node.lineno, node.value)


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
    "name", ["requant_stereo", "requant_stereo_batch", "requant_stereo_fused", "hybrid",
             "synth", "unpack_fused"])
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
    rows = torch.from_numpy(wire.build_fused_chunk(  # granules K1 can read
        *syn.to_packed8(*(a.numpy() for a in packed)), 301))
    args = {
        "requant_stereo": ((packed,), (x, ginfo)),
        "requant_stereo_batch": ((batch,), (x, ginfo)),
        "hybrid": ((x, ginfo, state.store, v), P.hybrid_ref(x, ginfo, state.store, v)),
        "synth": ((x18, ginfo, state.v_fifo, v), P.synth_ref(x18, ginfo, state.v_fifo, v)),
        "unpack_fused": ((buf, 20, 301), P.unpack_fused_ref(buf, 20, 301)),
        "requant_stereo_fused": ((rows, 20, 301), P.requant_stereo_fused_ref(rows, 20, 301)),
    }[name]
    kernels.reset_launch_counts()
    wrapper = name.removesuffix("_batch")
    got = getattr(kernels, wrapper)(*args[0])
    for a, b in zip(got, args[1]):
        assert torch.equal(a, b)
    assert not any(kernels.all_counts().values())
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


@pytest.mark.parametrize("units, t_dim, want, g", [
    (128, 240, 264, 4),  # K2, 64 streams: runs of 4 already fill an H100
    (64, 240, 264, 4),  # K3, 64 streams
    (16, 37, 264, 2),  # 8 streams at T = 37: runs of 4 leave SMs idle
    (2, 128, 264, 1),  # K2, the Decoder's one stream
    (2, 1, 264, 1),
])
def test_run_length_fills_the_card(units, t_dim, want, g):
    """K2's and K3's granules per run: the longest run, up to 4, that still
    gives `want` units of work (two per SM)."""
    assert kernels.run_length(units, t_dim, want) == g
