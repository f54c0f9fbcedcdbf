"""The seek cell after a seek and its read became one device call: its
per-layer metric folded_pct.seek (reported in that cell's traced run alone,
and not by a port without the spans module), and the output check on that
call, whose first granules are the warm-up the read drops, so a fault shows
only where it lands past them."""

import sys
import types

import pytest

from cell_sizes import run_cell

CELLS = ["fma.fetch", "fma.ondevice", "player.seek", "player.read"]


@pytest.fixture
def spans():
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield spans
    spans.reset()


@pytest.mark.parametrize("cell", CELLS)
def test_folded_pct_is_the_seek_cells_alone(spans, cell):
    out = run_cell(cell, trace=1)
    assert out["correct"]
    if cell == "player.seek":  # every op's read carries its seek's warm-up
        assert out["metrics"]["folded_pct.seek"]["value"] == 100
    else:
        assert "folded_pct.seek" not in out["metrics"]


def test_without_the_spans_module_no_folded_pct(spans, monkeypatch):
    """The port as a commit before the spans module: the reader gives None,
    the run its other metrics."""
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    out = run_cell("player.seek", trace=1)
    assert out["correct"]
    assert "folded_pct.seek" not in out["metrics"] and "launches_per_op.seek" in out["metrics"]


def _granules_altered(orig):
    def chain(packed, state, valid, *a, **kw):
        pcm, new = orig(packed, state, valid, *a, **kw)
        pcm[:, ::576, 0] += 100  # one sample of each granule
        return pcm, new
    return chain


def test_fault_in_the_read_granules_is_not_correct(monkeypatch):
    from go_mp3_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "chain", _granules_altered(kernels.chain))
    out = run_cell("player.seek")
    assert not out["correct"], out["compared"].numbers()
