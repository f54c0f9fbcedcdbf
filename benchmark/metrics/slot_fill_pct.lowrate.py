"""Share of the lane-granule slots a corpus call shipped to the chain that
held a granule (the port's counters gomp3.corpus.granules over
gomp3.corpus.slots), in %. A lane that has ended still ships its rows until
the call's longest lane ends, so lanes of unequal length read below 100."""

from benchmark import program_spans


def read(r: dict):
    slots = program_spans.counter("gomp3.corpus.slots")
    granules = program_spans.counter("gomp3.corpus.granules")
    return 100.0 * granules / slots if slots and granules is not None else None
