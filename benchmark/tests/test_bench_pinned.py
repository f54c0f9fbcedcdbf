"""The Decoder's device call through its pinned staging: the per-layer
metric pinned_pct.seek (the port's counter gomp3.decoder.pinned_calls over
the window's ops), an entry of the seek cell alone; read as None where the
counter is absent (the CPU, whose staging is plain memory, or a port
before it), never an error. On the card (marked `card`): one pinned call
per device call, pinned host rows, and the linear decode's bytes from
staging filled with garbage."""

import json
import sys
import types

import pytest

from benchmark import program_spans
from benchmark import run as R
from benchmark.gen import traffic

from cell_sizes import SIZES, bench, run_cell

METRIC = "pinned_pct.seek"


@pytest.fixture
def spans():
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield spans
    spans.reset()


def test_entry_is_the_seek_cells_copies_counter():
    m = next(m for m in bench()["per_layer"] if m["name"] == METRIC)
    assert m == {"name": METRIC, "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": "copies",
                 "moves": "seek_p95_ms", "workloads": ["player.seek"]}
    assert bench()["per_layer"][-1] == m


@pytest.mark.parametrize("calls, ops, want", [(400, 400, 100.0), (100, 400, 25.0),
                                               (None, 400, None), (5, 0, None)])
def test_reader(monkeypatch, calls, ops, want):
    counts = {} if calls is None else {"gomp3.decoder.pinned_calls": calls}
    monkeypatch.setattr(program_spans, "totals", lambda: {"spans": {}, "counts": counts})
    assert R.load_metric(METRIC)({"ops": ops}) == want


@pytest.mark.parametrize("cell", ["player.seek", "player.read"])
def test_cpu_runs_report_no_pinned_share(spans, cell):
    """On the CPU the staging is plain memory: the counter stays absent and
    the traced run leaves the metric out, its other metrics in."""
    out = run_cell(cell, trace=1)
    assert out["correct"]
    assert METRIC not in out["metrics"]
    assert "gomp3.decoder.pinned_calls" not in spans.totals()["counts"]
    if cell == "player.seek":
        assert "card_ms_per_op.seek" in out["metrics"]


def test_without_the_spans_module_no_pinned_share(spans, monkeypatch):
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    assert R.load_metric(METRIC)({"ops": 10}) is None


def _track() -> bytes:
    cfg = json.loads((R.ROOT / "benchmark/configs/gomp3_player.json").read_text())
    cfg.update(tracks=1, track_seconds=6, pool=SIZES["gomp3_player"]["pool"])
    return traffic.tracks(cfg, 2 ** 31 + 3)[0].data


@pytest.mark.card
def test_decoder_ships_through_pinned_staging(card, spans):
    """Every device call of a Decoder on the card goes through its pinned
    staging (one gomp3.decoder.pinned_calls each), the host buffers are
    pinned and keep their addresses, and seeks over staging filled with
    0x5A bytes read the card's linear decode."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from go_mp3_tpu_torch import Decoder

    data = _track()
    linear = Decoder(data, device=card).read_all()
    d = Decoder(data, device=card)
    st = d._native._staging
    tensors = [v for v in vars(st).values() if isinstance(v, torch.Tensor)]
    host = [t for t in tensors if t.device.type == "cpu"]
    assert host and all(t.is_pinned() for t in host)
    ptrs = [t.data_ptr() for t in tensors]
    bpf = d.bytes_per_frame()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(20):
            for t in tensors:
                t.view(torch.uint8).fill_(0x5A)
            pos = ((d.length() // bpf) * i // 20) * bpf + 4 * (7 * i + 3)
            d.seek(pos)
            assert d.read(32768) == linear[pos:pos + 32768]
        d.read(-1)
    tot = spans.totals()
    calls = tot["spans"]["gomp3.decoder.h2d"]["n"]
    assert calls > 20 and tot["counts"]["gomp3.decoder.pinned_calls"] == calls
    assert [t.data_ptr() for t in tensors] == ptrs
