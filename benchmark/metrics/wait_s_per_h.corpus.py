"""Seconds the host blocked on the card inside decode_corpus_fast (the
port's span gomp3.corpus.wait: event and stream synchronizes) per hour of
audio decoded in the window."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds("gomp3.corpus.wait")
    return s * 3600.0 / r["audio_s"] if s is not None and r.get("audio_s") else None
