"""The port's own spans and counters (go_mp3_tpu_torch.spans), as the
per-layer metrics read them after a traced window: the port records them
only while a profiler runs, so their totals are the window's. A port
without that module, or a run that opened no such span, reads None, never
an error."""

from __future__ import annotations

import importlib

ROOTS = ("gomp3.decoder.open", "gomp3.decoder.seek", "gomp3.decoder.read")
CARD = ("gomp3.decoder.h2d", "gomp3.decoder.launch", "gomp3.decoder.d2h")


def totals() -> dict | None:
    try:
        mod = importlib.import_module("go_mp3_tpu_torch.spans")
    except ImportError:
        return None
    return mod.totals()


def _rows(names) -> list | None:
    t = totals()
    if t is None:
        return None
    rows = [t["spans"].get(n) for n in names]
    return None if any(r is None for r in rows) else rows


def seconds(*names: str) -> float | None:
    """The spans' summed host seconds; None if one is absent."""
    rows = _rows(names)
    return None if rows is None else sum(r["s"] for r in rows)


def mean_seconds(name: str) -> float | None:
    rows = _rows([name])
    return None if rows is None else rows[0]["s"] / rows[0]["n"]


def own_pct(roots) -> float | None:
    """100 x the roots' own time (what no span nested in them covers) over
    their time, over the roots that were opened."""
    t = totals()
    if t is None:
        return None
    rows = [t["spans"][n] for n in roots if n in t["spans"]]
    s = sum(r["s"] for r in rows)
    return 100.0 * sum(r["self_s"] for r in rows) / s if s > 0 else None


def counter(name: str) -> int | None:
    t = totals()
    return None if t is None else t["counts"].get(name)
