"""Share of ops whose device call went through the Decoder's pinned
staging (the port's counter gomp3.decoder.pinned_calls over the window's
ops), in %: one such call an op where the card runs the chain."""

from benchmark import program_spans


def read(r: dict):
    calls = program_spans.counter("gomp3.decoder.pinned_calls")
    return 100.0 * calls / r["ops"] if calls is not None and r.get("ops") else None
