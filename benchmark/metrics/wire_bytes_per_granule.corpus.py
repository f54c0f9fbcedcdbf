"""Bytes shipped to the card per granule returned (the port's counters
gomp3.corpus.wire_bytes over gomp3.corpus.granules): the wire rows, the
padding of a lane's last chunk included."""

from benchmark import program_spans


def read(r: dict):
    nbytes = program_spans.counter("gomp3.corpus.wire_bytes")
    granules = program_spans.counter("gomp3.corpus.granules")
    return nbytes / granules if nbytes is not None and granules else None
