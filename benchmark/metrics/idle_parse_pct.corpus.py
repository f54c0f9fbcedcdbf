"""Of the traced window's longest idle gaps of the card (benchmark/tracing.py,
ten), the share of their time that the host spent in the port's own span
gomp3.corpus.parse (each gap's host_self). None where the port recorded no
gomp3.corpus.call in the window (a port without those spans)."""

from benchmark import program_spans


def read(r: dict):
    trace = r.get("trace")
    gaps = trace["gaps"] if trace else []
    if program_spans.seconds("gomp3.corpus.call") is None or not gaps:
        return None
    total = sum(g["us"] for g in gaps)
    parse = sum(us for g in gaps for n, us in g["host_self"] if n == "gomp3.corpus.parse")
    return 100.0 * parse / total if total > 0 else None
