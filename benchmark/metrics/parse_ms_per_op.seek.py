"""Host milliseconds of the Decoder's C++ parse into its host arrays (the
port's span gomp3.decoder.parse) per op."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds("gomp3.decoder.parse")
    return s * 1e3 / r["ops"] if s is not None and r.get("ops") else None
