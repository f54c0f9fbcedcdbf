"""The per-layer metric parse_wait_s_per_h.corpus: the port's span
gomp3.corpus.parse_wait (decode_corpus_fast's caller joining the worker
that parsed its next segment ahead) per audio hour, an entry of the four
corpus cells; read as None where the span is absent (a port before the
parse ran ahead, or a window with no corpus call), never an error."""

import sys
import types

import pytest

from benchmark import run as R

from cell_sizes import bench, run_cell

METRIC = "parse_wait_s_per_h.corpus"
CELLS = ["fma.fetch", "fma.ondevice", "speech_lsf.ondevice", "fma.lowrate"]


@pytest.fixture
def spans():
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield spans
    spans.reset()


def test_entry_is_the_corpus_cells_driver_span():
    m = next(m for m in bench()["per_layer"] if m["name"] == METRIC)
    assert m == {"name": METRIC, "unit": "s/audio-h", "better": "lower",
                 "source": "program_span", "layer": "corpus driver",
                 "moves": "corpus_xrt", "workloads": CELLS}
    for cell in CELLS:
        _, layer = R.metrics_of(bench(), R.cell_of(bench(), cell))
        assert METRIC in {m["name"] for m in layer}, cell


@pytest.mark.parametrize("seconds, audio_s, want", [(0.5, 1800.0, 1.0), (0.0, 60.0, 0.0),
                                                    (None, 60.0, None), (0.2, 0.0, None)])
def test_reader(monkeypatch, seconds, audio_s, want):
    from benchmark import program_spans

    rows = {} if seconds is None else {
        "gomp3.corpus.parse_wait": {"n": 3, "s": seconds, "self_s": seconds}}
    monkeypatch.setattr(program_spans, "totals", lambda: {"spans": rows, "counts": {}})
    assert R.load_metric(METRIC)({"audio_s": audio_s}) == want


@pytest.mark.parametrize("cell", ["fma.ondevice", "player.read"])
def test_cpu_runs_report_it_in_the_corpus_cells(spans, cell):
    """A traced run of a corpus cell waits on every parse it joins and
    reports the metric; the player's reads never call the corpus and
    leave it out."""
    out = run_cell(cell, trace=1)
    assert out["correct"]
    got = spans.totals()
    if cell == "fma.ondevice":
        value = out["metrics"][METRIC]["value"]
        assert 0 <= value
        assert got["spans"]["gomp3.corpus.parse_wait"]["n"] == \
            got["spans"]["gomp3.corpus.parse"]["n"]
    else:
        assert METRIC not in out["metrics"]
        assert "gomp3.corpus.parse_wait" not in got["spans"]


def test_without_the_spans_module_no_parse_wait(spans, monkeypatch):
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    assert R.load_metric(METRIC)({"audio_s": 60.0}) is None
