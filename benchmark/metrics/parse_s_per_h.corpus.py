"""Seconds of the C++ parse (decode_corpus_fast's phase "parse", host clock)
per hour of audio decoded in the window."""


def read(r: dict):
    if not r.get("audio_s"):
        return None
    return r["phase_seconds"]["parse"] * 3600.0 / r["audio_s"]
