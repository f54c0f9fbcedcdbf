"""Kernel launches of the port (ops.kernels.launch_counts, summed) per
minute of audio read."""


def read(r: dict):
    return r["launches"] * 60.0 / r["audio_s"] if r.get("audio_s") else None
