"""Host seconds the Decoder's caller waited joining its readahead prefetch
(the port's span gomp3.decoder.prefetch_wait: the part of the next
readahead's parse that running it on a worker thread did not hide) per
hour of audio read in the window; None where the port has no such span."""

from benchmark import program_spans


def read(r: dict):
    s = program_spans.seconds("gomp3.decoder.prefetch_wait")
    return s * 3600.0 / r["audio_s"] if s is not None and r.get("audio_s") else None
