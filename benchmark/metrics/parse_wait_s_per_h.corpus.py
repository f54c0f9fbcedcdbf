"""Host seconds decode_corpus_fast's caller waited joining the parse of its
next segment (the port's span gomp3.corpus.parse_wait: the part of that
parse, run ahead on a worker thread, that the caller's pack, copies and
emit did not hide) per hour of audio decoded in the window; None where
the port has no such span."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds("gomp3.corpus.parse_wait")
    return s * 3600.0 / r["audio_s"] if s is not None and r.get("audio_s") else None
