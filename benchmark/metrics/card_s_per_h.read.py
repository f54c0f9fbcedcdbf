"""Host seconds in the Decoder's calls to the card (the port's spans
gomp3.decoder.h2d, .launch and .d2h, the last waiting for the chain) per
hour of audio read in the window."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds(*program_spans.CARD)
    return s * 3600.0 / r["audio_s"] if s is not None and r.get("audio_s") else None
