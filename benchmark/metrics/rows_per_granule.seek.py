"""Granule rows the Decoder copied to the card per granule it decoded (the
port's counters gomp3.decoder.rows over gomp3.decoder.granules)."""

from benchmark import program_spans


def read(r: dict):
    rows = program_spans.counter("gomp3.decoder.rows")
    granules = program_spans.counter("gomp3.decoder.granules")
    return rows / granules if rows is not None and granules else None
