"""Reduction of a torch.profiler window to the device's activity, in memory.

_merge, _self_time and summarize are frozen copies of
go_mp3_tpu_torch/tools/profile_decode.py at commit 6b659fa (its :135-222,
whose lines joined by newlines have the sha256 below), with two parameters
added, the window's name and how many gaps to keep, and only the gaps kept
named (the host events that overlap each), so that a window of many
launches reduces in seconds. benchmark/tests/test_bench_copies.py holds the
copy against the original while those lines are unchanged.
"""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a trace
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
CHAIN_KERNEL = "chain_kernel"  # in the name of each of csrc/chain.cu's __global__ functions
WINDOW = "benchmark window"  # the record_function around a measured window
ORIGINAL = ("go_mp3_tpu_torch/tools/profile_decode.py", 135, 222,
            "8bc4c556c361bef523efdf36e8237ef7ed15d3516d2df76b2017dba3163f4bf6")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _self_time(host: list[dict], a: float, b: float) -> list:
    """The host's time in [a, b] by name, each event's own time (the time
    of the events nested in it, on its thread, taken out), longest first
    -> [[name, us], ...]."""
    threads: dict = {}
    for h in host:
        threads.setdefault((h.get("pid"), h.get("tid")), []).append(h)
    own: dict = {}
    for evs in threads.values():
        stack: list = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            # the innermost event that holds all of e is its parent (a
            # record_function's event outlasts the Python call that opened it)
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < e["ts"] + e["dur"]:
                stack.pop()
            ov = max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
            own[e["name"]] = own.get(e["name"], 0.0) + ov
            if stack:
                own[stack[-1]["name"]] -= ov
            stack.append(e)
    return sorted(([n, us] for n, us in own.items() if us > 0), key=lambda x: -x[1])


def summarize(events: list[dict], window: str = WINDOW, n_gaps: int = 5) -> dict:
    """The device's activity in a Chrome trace's events (microseconds),
    within the host event named `window` (or, where there is none, the span
    of every event):
     - busy_us and busy_share: the union of the kernel, memcpy and memset
       intervals, clipped to the window, over the window;
     - by_name: {name: {"cat", "count", "us"}} of the device events that
       overlap the window, longest first;
     - gaps: the n_gaps longest intervals of the window with no device
       activity, each with the host op that spans it (host_op: of the host
       events inside the window, the innermost of largest overlap; the
       window's name where none overlaps) and the host's own time in it by
       name (host_self: the three largest, [name, us]);
     - chain_events: the chain kernel's events in the window."""
    xs = [e for e in events if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == window]
    if win:
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    elif xs:
        w0 = min(e["ts"] for e in xs)
        w1 = max(e["ts"] + e["dur"] for e in xs)
    else:
        w0 = w1 = 0.0
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    host = [e for e in xs if str(e.get("cat", "")).lower() in HOST_CATS]
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    busy_us = sum(b - a for a, b in busy)
    by_name: dict = {}
    for e in dev:
        row = by_name.setdefault(e["name"], {"cat": e["cat"], "count": 0, "us": 0.0})
        row["count"] += 1
        row["us"] += e["dur"]
    # the window's own event and the host events around it say nothing of a gap
    inner = [h for h in host if not (h["ts"] <= w0 and h["ts"] + h["dur"] >= w1)]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans.sort(key=lambda ab: -(ab[1] - ab[0]))  # stable, as the original's sort
    gaps = []
    for a, b in spans[:n_gaps]:  # only the gaps kept are named
        near = [h for h in inner if h["ts"] < b and h["ts"] + h["dur"] > a]
        over = [(min(b, h["ts"] + h["dur"]) - max(a, h["ts"]), -h["dur"], h["name"])
                for h in near]
        gaps.append({"start_us": a - w0, "us": b - a,
                     "host_op": max(over)[2] if over else window,
                     "host_self": _self_time(near, a, b)[:3]})
    span = w1 - w0
    return {
        "window_us": span,
        "busy_us": busy_us,
        "busy_share": busy_us / span if span > 0 else 0.0,
        "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["us"])),
        "gaps": gaps,
        "chain_events": sum(1 for e in dev if CHAIN_KERNEL in e["name"]),
    }


# -- from the profiler, in memory ---------------------------------------------


def _device_cat(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "gpu_memcpy"
    if low.startswith("memset"):
        return "gpu_memset"
    return "kernel"


def profile_events(prof) -> list[dict]:
    """A finished torch.profiler.profile's events as Chrome-trace dicts
    (microseconds): device events with their category, host events as
    cpu_op. Read from kineto's results as they are, without the profiler's
    own tree of FunctionEvents, which takes minutes for a window of many
    launches. A record_function span also shows on the device's timeline
    (kineto's gpu_user_annotation), over all the device work it holds:
    that copy is left out, since it is no device activity."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        name = e.name()
        if kind == "CPU":
            if name.startswith("[memory]"):
                continue
            cat = "cpu_op"
        elif kind == "CUDA" and not e.is_user_annotation():
            cat = _device_cat(name)
        else:
            continue
        out.append({"ph": "X", "name": name, "ts": e.start_ns() / 1e3,
                    "dur": e.duration_ns() / 1e3, "cat": cat, "pid": 0,
                    "tid": e.start_thread_id()})
    return out


def chain_device_us(summary: dict) -> float:
    return sum(r["us"] for n, r in summary["by_name"].items() if CHAIN_KERNEL in n)


def breakdown(summary: dict, n: int = 10) -> dict:
    """The result line's breakdown: the device ops of most time and the
    longest idle gaps by the host op under each, in seconds."""
    ops = [[name, r["us"] / 1e6] for name, r in list(summary["by_name"].items())[:n]]
    gaps = [[g["host_op"], g["us"] / 1e6] for g in summary["gaps"][:n]]
    return {"device_ops": ops, "idle_gaps": gaps}
