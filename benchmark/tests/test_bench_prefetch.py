"""The per-layer metric prefetch_wait_s_per_h.read: the port's span
gomp3.decoder.prefetch_wait (the Decoder's caller joining the worker that
parsed its next readahead) per audio hour, an entry of the read cell
alone; read as None where the span is absent (a port before the prefetch,
or a window whose decodes joined none), never an error."""

import sys
import types

import pytest

from benchmark import program_spans
from benchmark import run as R

from cell_sizes import bench, run_cell

METRIC = "prefetch_wait_s_per_h.read"


@pytest.fixture
def spans():
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield spans
    spans.reset()


def test_entry_is_the_read_cells_stream_decoder_span():
    m = next(m for m in bench()["per_layer"] if m["name"] == METRIC)
    assert m == {"name": METRIC, "unit": "s/audio-h", "better": "lower",
                 "source": "program_span", "layer": "stream decoder",
                 "moves": "stream_xrt", "workloads": ["player.read"]}


@pytest.mark.parametrize("seconds, audio_s, want", [(0.5, 1800.0, 1.0), (0.0, 60.0, 0.0),
                                                    (None, 60.0, None), (0.2, 0.0, None)])
def test_reader(monkeypatch, seconds, audio_s, want):
    rows = {} if seconds is None else {
        "gomp3.decoder.prefetch_wait": {"n": 3, "s": seconds, "self_s": seconds}}
    monkeypatch.setattr(program_spans, "totals", lambda: {"spans": rows, "counts": {}})
    assert R.load_metric(METRIC)({"audio_s": audio_s}) == want


@pytest.mark.parametrize("cell", ["player.read", "player.seek"])
def test_cpu_runs_report_it_in_the_read_cell(spans, cell):
    """A traced run of the read cell joins a prefetch at every readahead
    but each open's and reports the metric; the seek cell's ops join none
    and its run leaves the metric out."""
    out = run_cell(cell, trace=1)
    assert out["correct"]
    counts = spans.totals()["counts"]
    if cell == "player.read":
        assert out["metrics"][METRIC]["value"] >= 0
        assert counts["gomp3.decoder.prefetched"] > 0
    else:
        assert METRIC not in out["metrics"]
        assert "gomp3.decoder.prefetched" not in counts


def test_without_the_spans_module_no_prefetch_wait(spans, monkeypatch):
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    assert R.load_metric(METRIC)({"audio_s": 60.0}) is None
