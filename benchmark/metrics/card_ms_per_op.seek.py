"""Host milliseconds in the Decoder's calls to the card (the port's spans
gomp3.decoder.h2d, .launch and .d2h, the last waiting for the chain) per
op."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds(*program_spans.CARD)
    return s * 1e3 / r["ops"] if s is not None and r.get("ops") else None
