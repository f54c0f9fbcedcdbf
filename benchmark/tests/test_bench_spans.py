"""The per-layer metrics that read the port's own spans and counters
(go_mp3_tpu_torch.spans, through benchmark/program_spans.py): each cell's
traced run reports its own and no other cell's; a port without the spans
module, as a commit before it, reports none of them and raises nothing;
and the trace's idle gaps name the port's spans."""

import json
import sys
import types

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import run as R
from benchmark import tracing
from benchmark.gen import traffic

from cell_sizes import SIZES, bench, run_cell

NEW = {
    "wait_s_per_h.corpus": ["fma.fetch", "fma.ondevice"],
    "unspanned_pct.corpus": ["fma.fetch", "fma.ondevice"],
    "idle_parse_pct.corpus": ["fma.fetch", "fma.ondevice"],
    "warmup_frames_per_op.seek": ["player.seek"],
    "rows_per_granule.seek": ["player.seek"],
    "card_ms_per_op.seek": ["player.seek"],
    "parse_ms_per_op.seek": ["player.seek"],
    "unspanned_pct.seek": ["player.seek"],
    "open_ms_per_op.read": ["player.read"],
    "card_s_per_h.read": ["player.read"],
    "unspanned_pct.read": ["player.read"],
}
CELLS = ["fma.fetch", "fma.ondevice", "player.seek", "player.read"]
LEAVES = ("gomp3.corpus.parse", "gomp3.corpus.pack", "gomp3.corpus.emit",
          "gomp3.corpus.wait")


@pytest.fixture
def spans():
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield spans
    spans.reset()


def test_new_metrics_are_entries_with_their_cells():
    b = bench()
    got = {m["name"]: m for m in b["per_layer"]}
    for name, cells in NEW.items():
        assert got[name]["workloads"] == cells
    assert list(got)[-len(NEW):] == list(NEW)  # appended, in this order


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_its_new_metrics(spans, cell):
    out = run_cell(cell, trace=1)
    assert out["correct"]
    want = {n for n, cells in NEW.items() if cell in cells}
    assert want and set(out["metrics"]) & set(NEW) == want
    values = {n: out["metrics"][n]["value"] for n in want}
    for name, v in values.items():
        assert v >= 0, name
        if name.startswith(("unspanned_pct", "idle_parse_pct")):
            assert v <= 100, name
    if cell == "player.seek":
        assert 1 <= values["rows_per_granule.seek"] <= 128
        assert 0 < values["warmup_frames_per_op.seek"] <= 5


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_spans_module_no_new_metric(spans, cell, monkeypatch):
    """The port as a commit before the spans module: nothing recorded, the
    module not importable; the readers give None, the run its other
    metrics."""
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    out = run_cell(cell, trace=1)
    assert out["correct"]
    assert out["metrics"] and not set(out["metrics"]) & set(NEW)
    assert spans.totals() == {"spans": {}, "counts": {}}


def test_idle_gaps_name_the_corpus_parse(spans):
    """A CPU window of decode_corpus_fast: its one gap (no device here) is
    named by the port's own span; with the plain chain's ops outside the
    host phases standing in for the card's work, the longest gaps' host
    time is the port's spans', gomp3.corpus.parse the first of them."""
    from go_mp3_tpu_torch import decode_corpus_fast

    cfg = {**json.loads((R.HERE / "configs" / "fma_clips.json").read_text()),
           **SIZES["fma_clips"]}
    data = [s.data for s in traffic.clip_batches(cfg, {"batch_clips": 4}, 2 ** 31 + 7)[0]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            decode_corpus_fast(data, chunk_t=64, device="cpu")
    events = tracing.profile_events(prof)
    whole = tracing.summarize(events, n_gaps=10)["gaps"]
    assert len(whole) == 1 and whole[0]["host_op"] == "gomp3.corpus.call"
    leaves = [e for e in events if e["name"] in LEAVES]

    def in_leaf(e):
        return any(a["ts"] <= e["ts"] and e["ts"] + e["dur"] <= a["ts"] + a["dur"]
                   for a in leaves)

    card = [dict(e, cat="kernel") for e in events
            if e["name"].startswith("aten::") and not in_leaf(e)]
    gaps = tracing.summarize(events + card, n_gaps=10)["gaps"]
    assert len(gaps) == 10
    assert gaps[0]["host_self"][0][0] == "gomp3.corpus.parse"
    assert all(g["host_self"][0][0].startswith("gomp3.corpus.") for g in gaps)
