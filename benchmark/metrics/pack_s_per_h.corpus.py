"""Seconds of the wire builder (phase "pack", host clock) per hour of audio
decoded in the window."""


def read(r: dict):
    if not r.get("audio_s"):
        return None
    return r["phase_seconds"]["pack"] * 3600.0 / r["audio_s"]
