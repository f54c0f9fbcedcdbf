"""The host's clock and this process's use of it, read around a call or a
window: to tell a call that did more work from one that waited for a core."""

from __future__ import annotations

import os
import resource
import time


def _steal_s() -> float:
    """Seconds that the hypervisor gave this machine's cores to others,
    summed over the cores (/proc/stat), or NaN where it is not told."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return float("nan")


def now() -> dict:
    """The wall, the calling thread's CPU seconds, the process's user and
    system CPU seconds, and the machine's stolen seconds."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall": time.perf_counter(), "thread_cpu": time.thread_time(),
            "user": r.ru_utime, "sys": r.ru_stime, "steal": _steal_s()}


def since(start: dict) -> dict:
    """Each reading's change since `start` (a now())."""
    return {k: v - start[k] for k, v in now().items()}
