"""Milliseconds of a Decoder's open from bytes (the port's span
gomp3.decoder.open: the index of the track and the first decode), per
open."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.mean_seconds("gomp3.decoder.open")
    return None if s is None else s * 1e3
