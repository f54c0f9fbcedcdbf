"""The port's golden backend and conformance bundle (go_mp3_tpu_torch/
golden/, go_mp3_tpu_torch/conformance.py) against go_mp3_tpu's golden
backend and conformance/REPORT.json, on the CPU.

Golden PCM is the same numpy oracle on the same parsed frames, so it must
be byte-identical to go_mp3_tpu's and to REPORT.json's frozen SHA-256."""

import ast
import hashlib
import inspect
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu import GaplessDecoder as JaxGapless  # noqa: E402
from go_mp3_tpu.ops import reference_dsp as jax_reference_dsp  # noqa: E402
from go_mp3_tpu_torch import Decoder, GaplessDecoder, conformance  # noqa: E402
from go_mp3_tpu_torch.bitstream.frameheader import FrameHeader  # noqa: E402
from go_mp3_tpu_torch.golden import GoldenDecoder  # noqa: E402
from go_mp3_tpu_torch.golden import reference_dsp  # noqa: E402

CONF = Path(__file__).resolve().parent.parent / "conformance"
REPORT = json.loads((CONF / "REPORT.json").read_text())
NAMES = ["synthetic_escape", "synthetic_lowrate"]


def _data(name: str, times: int = 1) -> bytes:
    return (CONF / f"{name}.mp3").read_bytes() * times


@pytest.mark.parametrize("name", NAMES)
def test_golden_equals_jax_golden_and_report(name):
    data = _data(name)
    got = Decoder(data, backend="golden").read_all()
    assert got == JaxDecoder(data, backend="golden").read_all()
    want = REPORT["files"][name]["backends"]["golden"]["pcm_sha256"]
    assert hashlib.sha256(got).hexdigest() == want


@pytest.mark.parametrize("name", NAMES)
def test_golden_seek_and_gapless_equal_jax(name):
    data = _data(name, 3)
    port, ref = Decoder(data, backend="golden"), JaxDecoder(data, backend="golden")
    assert port.length() == ref.length() > 0
    for d in (port, ref):
        d.seek(d.length() // 3)
    assert port.tell() == ref.tell() and port.read(20000) == ref.read(20000)
    assert (GaplessDecoder(data, backend="golden").read_all()
            == JaxGapless(data, backend="golden").read_all())


def _code_without_docstrings(module) -> str:
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


def test_golden_loader_is_the_same_oracle_code():
    """The port's oracle is the JAX package's reference_dsp, statement for
    statement (only docstrings may differ), and its bitstream classes are
    the port's own."""
    assert GoldenDecoder.__module__ == "go_mp3_tpu_torch.golden.reference_dsp"
    assert _code_without_docstrings(reference_dsp) == \
        _code_without_docstrings(jax_reference_dsp)
    assert sys.modules[GoldenDecoder.__module__].FrameHeader is FrameHeader


@pytest.mark.parametrize("name", NAMES)
def test_golden_checkpoint_crosses_packages(name):
    """A golden checkpoint taken on either package resumes on the other,
    byte for byte."""
    data = _data(name, 2)
    n = 5 * 4608 + 1000
    for make_a, make_b in (
        (lambda: JaxDecoder(data, backend="golden"),
         lambda: Decoder(data, backend="golden")),
        (lambda: Decoder(data, backend="golden"),
         lambda: JaxDecoder(data, backend="golden")),
    ):
        a = make_a()
        a.read(n)
        ck = a.checkpoint_bytes()
        rest = a.read_all()
        b = make_b()
        b.resume_bytes(ck)
        assert b.tell() == n and b.read_all() == rest


def test_conformance_main_passes_on_the_cpu(capsys):
    assert conformance.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name in NAMES:
        for backend in ("exact", "golden"):
            assert f"{name} {backend}: " in out
            assert REPORT["files"][name]["backends"][backend]["pcm_sha256"] in out
    assert out.count("byte-identical to the per-stream device decodes: True") == 2
    assert "conformance on cpu: PASS" in out


def test_conformance_fails_on_another_input(tmp_path, monkeypatch, capsys):
    """A bundle file whose bytes are not REPORT.json's fails the run."""
    report = json.loads(json.dumps(REPORT))
    report["files"] = {"synthetic_escape": report["files"]["synthetic_escape"]}
    (tmp_path / "REPORT.json").write_text(json.dumps(report))
    (tmp_path / "synthetic_escape.mp3").write_bytes(_data("synthetic_escape") + b"\0")
    monkeypatch.setattr(conformance, "BUNDLE", tmp_path)
    assert conformance.main(["--device", "cpu"]) == 1
    assert "input SHA-256 differs" in capsys.readouterr().out


def test_conformance_reads_bundle_files_from_its_own_checkout_only(
        tmp_path, monkeypatch, capsys):
    """A bundle file missing from BUNDLE fails the run: its recorded path,
    which may lie in another checkout, is never read."""
    report = json.loads(json.dumps(REPORT))
    report["files"] = {"synthetic_escape": report["files"]["synthetic_escape"]}
    report["files"]["synthetic_escape"]["path"] = str(CONF / "synthetic_escape.mp3")
    (tmp_path / "REPORT.json").write_text(json.dumps(report))
    monkeypatch.setattr(conformance, "BUNDLE", tmp_path)
    assert conformance.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "synthetic_escape: bundle file missing" in out
    assert "synthetic_escape exact:" not in out
