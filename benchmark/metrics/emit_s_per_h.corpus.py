"""Seconds of the emit (phase "emit": PCM rows out of the pinned buffers and
joined per clip, host clock) per hour of audio decoded in the window; none
where the PCM stays on the card."""


def read(r: dict):
    if not r.get("audio_s") or not r["phase_seconds"].get("emit"):
        return None
    return r["phase_seconds"]["emit"] * 3600.0 / r["audio_s"]
