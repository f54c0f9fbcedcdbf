"""The chain's share of its roofline: the least time of the window's chain
work (benchmark/roofline.py, counted from the generated streams) over the
device time of the kernels named chain_kernel* in the traced window."""

from benchmark import roofline, tracing


def read(r: dict):
    trace = r.get("trace")
    if trace is None or not r.get("chain_ops"):
        return None
    device_us = tracing.chain_device_us(trace)
    if device_us <= 0:
        return None
    least = roofline.least_seconds(r["chain_ops"], r["chain_bytes"])
    return 100.0 * least / (device_us / 1e6)
