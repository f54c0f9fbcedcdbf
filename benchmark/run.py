"""Run one cell of the benchmark of go_mp3_tpu_torch on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its metrics come from BENCHMARK.json at the
root of the checkout; the cell's traffic from benchmark/workloads/<cell>.json,
which names its driver (benchmark/drivers/<driver>.py); each per-layer
metric is read by benchmark/metrics/<metric>.py. Set-up (imports, the
port's builds, the inputs made from the seed, the warm-up) is timed as
setup_s; then the cell's ops run in a closed loop for --seconds, the
last op running to its end; with --trace 1 the window runs under
torch.profiler and the per-layer metrics are reported instead of the
end-to-end ones. After the window the outputs are checked against the
plain reference (benchmark/reference), and the last line of standard
output is the result as one JSON object.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
if __name__ == "__main__":
    # the checkout's root, not this folder, heads the path: benchmark/ is a package
    sys.path[0] = str(ROOT)


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr)
    sys.exit(code)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    fail(2, f"no cell {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict) -> tuple[list, list]:
    """The cell's end-to-end metrics and its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell["name"] in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_metric(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port builds its CUDA and C++ libraries under build/ itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)


def run_window(driver, seconds: float, op_s: list) -> float:
    """Ops until `seconds` have passed, the last one to its end -> the
    window's length; each op's seconds appended to op_s."""
    t0 = t = time.perf_counter()
    while True:
        driver.op()
        now = time.perf_counter()
        op_s.append(now - t)
        t = now
        if now - t0 >= seconds:
            return now - t0


def run(args, bench: dict, cell: dict, device: str, t_start: float,
        sizes: dict | None = None) -> dict:
    """Set-up, window, readings and check of one cell -> the result.
    sizes: keys that replace the configuration's and the workload's (the
    CPU tests run a cell at a size the CPU can hold)."""
    import torch

    from benchmark import hostuse, tracing

    wl = json.loads((HERE / "workloads" / f"{cell['name']}.json").read_text())
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    for key, value in (sizes or {}).items():
        (cfg if key in cfg else wl)[key] = value
    driver_mod = importlib.import_module(f"benchmark.drivers.{wl['driver']}")
    e2e_metrics, layer_metrics = metrics_of(bench, cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    driver = driver_mod.Driver(cfg, wl, args.seed, device)
    driver.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    prof, op_s = None, []
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(tracing.WINDOW):
                use = hostuse.now()  # after the profiler's start
                window_s = run_window(driver, args.seconds, op_s)
                use = hostuse.since(use)  # before its stop
                if cuda:
                    torch.cuda.synchronize()
    else:
        use = hostuse.now()
        window_s = run_window(driver, args.seconds, op_s)
        use = hostuse.since(use)
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    readings = {**driver.readings(), "window_s": window_s}

    result_device = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                     "count": cell["chips"], "memory_peak_bytes": memory_peak}
    metrics, breakdown = {}, None
    if prof is not None:
        summary = tracing.summarize(tracing.profile_events(prof), n_gaps=10)
        prof = None
        readings["trace"] = summary
        result_device["busy_s"] = summary["busy_us"] / 1e6
        result_device["window_s"] = summary["window_us"] / 1e6
        breakdown = tracing.breakdown(summary)
        for m in layer_metrics:
            value = load_metric(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**driver.end_to_end(window_s), "setup_s": setup_s}
        for m in e2e_metrics:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    attempted = driver.attempted()
    compared = driver.check(cfg["guarantee"]["limits"])
    return {"correct": compared.ok() and driver.failed == 0, "compared": compared,
            "metrics": metrics, "device": result_device,
            "breakdown": breakdown, "attempted": attempted, "failed": driver.failed,
            "op_s": op_s, "setup_s": setup_s, "per_call": readings.get("per_call", []),
            "host_use": use}


def result_line(out: dict, card: str | None) -> dict:
    """The result's JSON object: correct, attempted, failed, metrics,
    device, the traced run's breakdown, and last the numbers compared,
    each with its limit."""
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": {**out["device"], "card": card}}
    if out["breakdown"] is not None:
        result["breakdown"] = out["breakdown"]
    result["compared"] = out["compared"].numbers()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench_path = ROOT / "BENCHMARK.json"
    if not bench_path.is_file():
        fail(2, f"{bench_path} is missing")
    bench = json.loads(bench_path.read_text())
    cell = cell_of(bench, args.workload)

    from benchmark import imports

    bad = imports.violations()
    if bad:
        fail(4, "; ".join(bad))
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(3, f"the cell needs {cell['chips']} CUDA device(s); this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if not (ROOT / "go_mp3_tpu_torch").is_dir():
        fail(2, "the port go_mp3_tpu_torch is not in this checkout")

    out = run(args, bench, cell, "cuda", T0)
    found = imports.loaded_banned()
    if found:
        fail(4, f"the process loaded {', '.join(found)}")
    compared = out["compared"]
    numbers = compared.numbers()
    card = card_power_limit()
    op_s = sorted(out["op_s"])
    print(f"setup {out['setup_s']:.3f} s; {len(op_s)} ops in the window, seconds: min "
          f"{op_s[0]:.6f} median {op_s[len(op_s) // 2]:.6f} max {op_s[-1]:.6f}; "
          f"first {[round(x, 6) for x in out['op_s'][:4]]}", file=sys.stderr)
    for i, phases in enumerate(out["per_call"]):
        print(f"call {i}: " + " ".join(f"{k} {v:.4f}" for k, v in phases.items()),
              file=sys.stderr)
    print("window's host use: " + " ".join(f"{k} {v:.4f}" for k, v in out["host_use"].items())
          + f"; {os.cpu_count()} cores, {torch.get_num_threads()} torch threads",
          file=sys.stderr)
    for line in compared.worst[:10]:
        print(f"check: {line}", file=sys.stderr)
    print(f"card: {card}", file=sys.stderr)
    print(f"compared {compared.answers} answers with the reference", file=sys.stderr)
    for name, v in numbers.items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    result = result_line(out, card)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
