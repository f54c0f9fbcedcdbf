"""Share of the granules returned that were shipped on the half-width mono
wire (the port's counters gomp3.corpus.mono_granules over
gomp3.corpus.granules), in %. A call that reran unsplit, or fell to the
int16 interface, ships none on it."""

from benchmark import program_spans


def read(r: dict):
    mono = program_spans.counter("gomp3.corpus.mono_granules")
    granules = program_spans.counter("gomp3.corpus.granules")
    return 100.0 * mono / granules if mono is not None and granules else None
