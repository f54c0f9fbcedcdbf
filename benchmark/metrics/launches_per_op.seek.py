"""Kernel launches of the port (ops.kernels.launch_counts, summed) per op."""


def read(r: dict):
    return r["launches"] / r["ops"] if r.get("ops") else None
