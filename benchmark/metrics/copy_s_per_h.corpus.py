"""Seconds of the copies (phases "h2d" and "d2h", CUDA events) per hour of
audio decoded in the window."""


def read(r: dict):
    if not r.get("audio_s"):
        return None
    p = r["phase_seconds"]
    return (p["h2d"] + p["d2h"]) * 3600.0 / r["audio_s"]
