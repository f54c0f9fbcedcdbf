"""95th percentile of the benchmark's own span around Decoder.seek_to_time
alone (the warm-up decode), over every op of the window."""

import numpy as np


def read(r: dict):
    ms = r.get("seek_call_ms")
    return float(np.percentile(ms, 95)) if ms else None
