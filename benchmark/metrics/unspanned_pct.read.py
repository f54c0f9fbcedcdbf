"""The share of the Decoder's time (the port's root spans gomp3.decoder.open,
.seek and .read) that none of its inner spans (parse, h2d, launch, d2h)
covers: the PCM bytes, the buffer and the Python around them."""

from benchmark import program_spans


def read(r: dict):
    return program_spans.own_pct(program_spans.ROOTS)
