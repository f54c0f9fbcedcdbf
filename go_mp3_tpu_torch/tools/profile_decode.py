"""Profile the decode pipeline on the port (tools/profile_decode.py's and
tools/profile_parse.py's counterpart), in two sections.

    python -m go_mp3_tpu_torch.tools.profile_decode [--device cuda|cpu]

Host parse:
 - cProfile of the pure-Python parse (parallel.parse_stream_granules) of
   conformance/synthetic_escape.mp3 x32 (768 granules, 10.0 s of audio),
   the top 12 by cumulative time, and the wall time of the C++ parse of
   the same bytes (models.native_pipeline.parse_stream_native);
 - the C++ parser's interfaces timed apart (native/lib.py: index_stream,
   headers only; parse_into, int16 spectra and separate sfl/sfs/meta;
   parse_packed_into, int16 spectra and packed sidecar;
   parse_packed8_into, int8 tail, head and byte sidecar) on
   synthetic_escape.mp3 x128 and synthetic_lowrate.mp3 x110: the least
   wall time over 9 interleaved rounds, granules/s, x realtime.

Trace: torch.profiler (CPU and CUDA activity, Python functions with
with_stack) over warm windows, each
after an unprofiled warm-up run and an unprofiled timed run:
 (a) "chunk": one decode_chunk of 256 granules of one stream (the
     GranuleBatch that pack_granule_batch stages);
 (b) "corpus": one decode_corpus_fast run with its defaults over the smoke
     corpus's 64 lanes (tools/corpus.py);
 (c) "corpus_drain": the same with drain=4 (SegmentGraph replays).
For each: the Chrome trace under build/traces/<name>.json, key_averages()
sorted by self device time, the window's wall beside the unprofiled run's, and
the summary of the trace's events (summarize): the device's busy share
(the union of kernel, memcpy and memset intervals over the window), device
time by kernel name, the five longest idle gaps of the device with the
host op that spans each, and the chain kernel's events beside the chain
launches the wrappers counted in the window. On a CUDA device a trace
without a kernel event raises.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time
from pathlib import Path

import numpy as np
import torch

from ..consts import HEAD_WIDTH, META_WIDTH, SIDE8_WIDTH, SIDE_WIDTH, SP8_TAIL_WIDTH
from ..device import resolve_device
from ..models.native_pipeline import parse_stream_native
from ..models.pipeline import pack_granule_batch
from ..native import lib as native
from ..native.lib import NativeParser, index_stream
from ..ops.granule import batch_to, init_state
from ..ops import kernels as K
from ..parallel.corpus import decode_corpus_fast, parse_stream_granules
from ..parallel.segment import SegmentGraph
from .cardtime import device_label
from .corpus import ESCAPE, LOWRATE, corpus_lanes

TRACES = Path(__file__).resolve().parents[2] / "build" / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a trace
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")
CHAIN_KERNEL = "chain_kernel"  # in the name of each of csrc/chain.cu's __global__ functions
WINDOW = "profile_decode window"  # the record_function around a window


# -- host parse -----------------------------------------------------------------


def host_profile(data: bytes, top: int = 12) -> str:
    """cProfile of parse_stream_granules(data): the top `top` functions by
    cumulative time, as pstats prints them."""
    prof = cProfile.Profile()
    prof.enable()
    parse_stream_granules(data)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(top)
    return out.getvalue()


def native_parse_seconds(data: bytes) -> float:
    t0 = time.perf_counter()
    parse_stream_native(data)
    return time.perf_counter() - t0


def parse_interfaces(data: bytes, rounds: int = 9) -> dict:
    """The least wall time of each C++ parser interface over the whole
    stream, the interfaces taken in turn each round so that drift on a
    shared host hits them alike (process CPU time, which the original
    took, can tick too coarsely to time the header index) -> {"granules",
    "audio_s", "seconds": {interface: s}}."""
    cap = 8192
    bufs = {
        "parse_into": (np.zeros((cap, 2, 576), np.int16), np.zeros((cap, 2, 22), np.int32),
                       np.zeros((cap, 2, 39), np.int32), np.zeros((cap, META_WIDTH), np.int32)),
        "parse_packed_into": (np.zeros((cap, 1152), np.int16),
                              np.zeros((cap, SIDE_WIDTH), np.int16)),
        "parse_packed8_into": (np.zeros((cap, SP8_TAIL_WIDTH), np.int8),
                               np.zeros((cap, HEAD_WIDTH), np.int16),
                               np.zeros((cap, SIDE8_WIDTH), np.uint8)),
    }

    def run(name: str) -> int:
        p = NativeParser(data)
        try:
            total = 0
            while n := getattr(p, name)(*bufs[name]):
                total += n
            return total
        finally:
            p.close()

    granules = run("parse_packed8_into")
    _, _, sample_rate = index_stream(data)
    fns = {"index_stream (headers)": lambda: index_stream(data),
           **{name: lambda name=name: run(name) for name in bufs}}
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            best[name] = min(best[name], time.perf_counter() - t0)
    return {"granules": granules, "audio_s": granules * 576 / sample_rate,
            "seconds": best}


# -- trace ----------------------------------------------------------------------


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


def summarize(events: list[dict]) -> dict:
    """The device's activity in a Chrome trace's events (microseconds),
    within the host event named WINDOW (or, where there is none, the span
    of every event):
     - busy_us and busy_share: the union of the kernel, memcpy and memset
       intervals, clipped to the window, over the window;
     - by_name: {name: {"cat", "count", "us"}} of the device events that
       overlap the window, longest first;
     - gaps: the five longest intervals of the window with no device
       activity, each with the host op that spans it (host_op: of the host
       events inside the window, the innermost of largest overlap; the
       window's name where none overlaps) and the host's own time in it by
       name (host_self: the three largest, [name, us]);
     - chain_events: the chain kernel's events in the window."""
    xs = [e for e in events if isinstance(e, dict) and e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW]
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
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        over = [(min(b, h["ts"] + h["dur"]) - max(a, h["ts"]), -h["dur"], h["name"])
                for h in inner if h["ts"] < b and h["ts"] + h["dur"] > a]
        gaps.append({"start_us": a - w0, "us": b - a,
                     "host_op": max(over)[2] if over else WINDOW,
                     "host_self": _self_time(inner, a, b)[:3]})
    gaps.sort(key=lambda g: -g["us"])
    span = w1 - w0
    return {
        "window_us": span,
        "busy_us": busy_us,
        "busy_share": busy_us / span if span > 0 else 0.0,
        "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]["us"])),
        "gaps": gaps[:5],
        "chain_events": sum(1 for e in dev if CHAIN_KERNEL in e["name"]),
    }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def trace_window(name: str, fn, dev: torch.device, out_dir: Path = TRACES) -> dict:
    """fn() three times: a warm-up, an unprofiled timed run and a run under
    torch.profiler (CPU and, on CUDA, CUDA activity; Python functions
    recorded) inside the WINDOW record_function. Writes the Chrome trace to out_dir/<name>.json ->
    {"name", "trace", "wall_s", "unprofiled_wall_s", "chain_launches",
    "graph_replays", "table" (key_averages by self device time), **summarize}.
    On CUDA, a trace without a kernel event raises RuntimeError."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    _sync(dev)
    t0 = time.perf_counter()
    fn()
    _sync(dev)
    unprofiled = time.perf_counter() - t0
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    launches, replays = K.all_counts()["chain"], SegmentGraph.replays
    # with_stack: the Python functions too, so that a gap of the device
    # names the host code under it (the parse, the pack and the emit run
    # no torch op)
    with profile(activities=activities, with_stack=True) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            _sync(dev)
        wall = time.perf_counter() - t0
    launches = K.all_counts()["chain"] - launches
    replays = SegmentGraph.replays - replays
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.json"
    prof.export_chrome_trace(str(path))
    summary = summarize(json.loads(path.read_text())["traceEvents"])
    if dev.type == "cuda" and not any(str(r["cat"]).lower() == "kernel"
                                       for r in summary["by_name"].values()):
        raise RuntimeError(f"{name}: the trace {path} holds no kernel event: "
                           f"torch.profiler recorded no device activity")
    # by self time: a Python function's total holds all that runs under it
    averages = prof.key_averages()
    if dev.type != "cuda":
        table = averages.table(sort_by="self_cpu_time_total", row_limit=15)
    else:
        try:
            table = averages.table(sort_by="self_device_time_total", row_limit=15)
        except (AttributeError, KeyError):  # a torch from before the rename
            table = averages.table(sort_by="self_cuda_time_total", row_limit=15)
    return {"name": name, "trace": str(path), "wall_s": wall,
            "unprofiled_wall_s": unprofiled, "chain_launches": launches,
            "graph_replays": replays, "table": table, **summary}


def chunk_window(data: bytes, granules: int, dev: torch.device):
    """Window (a): -> a callable that decodes the first `granules`
    granules of `data` as one chunk of one stream on `dev`."""
    batch, n = pack_granule_batch(parse_stream_granules(data, granules)[:granules],
                                  pad_to=granules)
    batch = batch_to(batch, dev)
    state = init_state(1, dev)
    valid = torch.tensor([n], dtype=torch.int32, device=dev)
    return lambda: K.decode_chunk(batch, state, valid)


def windows(dev: torch.device, lanes: list[bytes]) -> dict:
    """The trace windows over `lanes`: name -> the callable each profiles."""
    return {
        "chunk": chunk_window(ESCAPE.read_bytes() * 32, 256, dev),
        "corpus": lambda: decode_corpus_fast(lanes, device=dev),
        "corpus_drain": lambda: decode_corpus_fast(lanes, drain=4, device=dev),
    }


def print_window(w: dict) -> None:
    print(f"== trace [{w['name']}]: {w['trace']}")
    print(w["table"])
    print(f"window wall {w['wall_s']:.4f} s profiled, {w['unprofiled_wall_s']:.4f} s "
          f"unprofiled; device busy {w['busy_us'] / 1e3:.3f} ms of "
          f"{w['window_us'] / 1e3:.3f} ms ({100 * w['busy_share']:.2f}%)")
    print(f"chain kernel: {w['chain_events']} trace events, {w['chain_launches']} "
          f"launches counted, {w['graph_replays']} graph replays")
    print("device time by name:")
    for name, r in list(w["by_name"].items())[:10]:
        print(f"  {r['us'] / 1e3:10.3f} ms  {r['count']:6d}x  [{r['cat']}] {name[:110]}")
    print("longest device idle gaps:")
    for g in w["gaps"]:
        own = ", ".join(f"{n[:60]} {us / 1e3:.3f} ms" for n, us in g["host_self"])
        print(f"  {g['us'] / 1e3:10.3f} ms at +{g['start_us'] / 1e3:.3f} ms, "
              f"under {g['host_op']}; host's own time: {own}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m go_mp3_tpu_torch.tools.profile_decode",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the traced decodes run (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {device_label(dev)}")

    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("the C++ parser (libmp3parse.so) did not build")
    print(f"C++ parser build and load: {time.perf_counter() - t0:.2f} s (not timed below)")
    data = ESCAPE.read_bytes() * 32
    print("== host parse (python): cProfile of parse_stream_granules, "
          "synthetic_escape.mp3 x32")
    print(host_profile(data))
    print(f"== host parse (native): parse_stream_native {native_parse_seconds(data):.4f} s")
    for label, stream in (("synthetic_escape.mp3 x128", ESCAPE.read_bytes() * 128),
                          ("synthetic_lowrate.mp3 x110", LOWRATE.read_bytes() * 110)):
        r = parse_interfaces(stream)
        print(f"== {label}: {r['granules']} granules, {r['audio_s']:.1f} s of audio "
              f"(least wall time of 9 rounds)")
        for name, t in r["seconds"].items():
            print(f"  {name:24s} {t * 1e3:8.2f} ms  {r['granules'] / t / 1e3:8.0f}k gr/s  "
                  f"{r['audio_s'] / t:8.0f}x realtime")

    # the smoke corpus on the card; on the CPU, whose plain chain is ~1000x
    # slower, 4 + 4 lanes of 4 copies
    lanes = corpus_lanes() if dev.type == "cuda" else corpus_lanes(4, 4, 4, 4)
    print(f"== trace windows: corpus of {len(lanes)} lanes, {sum(map(len, lanes))} B")
    summary = []
    for name, fn in windows(dev, lanes).items():
        w = trace_window(name, fn, dev)
        print_window(w)
        summary.append({k: v for k, v in w.items() if k != "table"})
    print(json.dumps({"device": device_label(dev), "windows": summary}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
