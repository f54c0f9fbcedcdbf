"""The share of the traced window in which no kernel, copy or set ran on
the device (the union of their intervals, benchmark/tracing.py)."""


def read(r: dict):
    trace = r.get("trace")
    if trace is None or trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_share"])
