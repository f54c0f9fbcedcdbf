"""Nothing the benchmark runs imports jax or the JAX package, and the plain
reference imports nothing of the port: top-level names compared whole."""

import subprocess
import sys

from benchmark import imports


def test_sources_import_nothing_banned():
    assert imports.violations() == []


def test_names_are_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy\nfrom go_mp3_tpu_torch.ops import kernels\n"
                 "from go_mp3_tpu.ops import granule\nimport jaxtyping\n")
    tops = imports.closure([f])
    assert tops & imports.BANNED == {"jax", "go_mp3_tpu"}
    assert "go_mp3_tpu_torch" in tops and "jaxtyping" in tops


def test_reference_closure_follows_the_benchmarks_modules():
    ref = imports.closure(sorted((imports.HERE / "reference").rglob("*.py")))
    assert "numpy" in ref and imports.PORT not in ref
    assert "benchmark" in ref  # the Huffman tables of benchmark/gen


def test_a_run_loads_nothing_banned():
    """The modules a cell's driver and the reference load, in a fresh
    process: no jax, jaxlib, flax or go_mp3_tpu."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.run, benchmark.drivers.corpus, benchmark.drivers.player_seek\n"
            "import benchmark.drivers.player_read, benchmark.reference.decode\n"
            "import go_mp3_tpu_torch.parallel, go_mp3_tpu_torch.decoder\n"
            "from benchmark import imports; print(imports.loaded_banned())"
            % str(imports.HERE.parent))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"
