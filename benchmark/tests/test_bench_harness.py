"""The harness: driven by data (a cell, a configuration or a metric is new
files), its result line, its refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run as R

from cell_sizes import SIZES, bench, run_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_metrics_of_each_cell():
    b = bench()
    for cell in b["workloads"]:
        e2e, layer = R.metrics_of(b, cell)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer and all(m["moves"] in names for m in layer)
        for m in layer:
            assert (R.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert (R.HERE / "workloads" / f"{cell['name']}.json").is_file()


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
    out = run_cell("fma.fetch", trace=trace)
    line = R.result_line(out, "a card, 700.00 W")
    want = KEYS + (["breakdown"] if trace else []) + ["compared"]
    assert list(line) == want  # the numbers compared come last
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["compared"]) == {"length_mismatches", "max_abs_lsb", "rms_lsb"}
    assert all(set(v) == {"value", "limit"} for v in line["compared"].values())
    b = bench()
    e2e, layer = R.metrics_of(b, R.cell_of(b, "fma.fetch"))
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
    json.dumps(line)


def test_a_new_cell_config_and_metric_are_new_files(tmp_path):
    """A copy of the benchmark with a new configuration, traffic mix and
    per-layer metric added as files and entries: the new cell runs and
    reports the new metric; no file of the benchmark was edited."""
    root = tmp_path / "checkout"
    shutil.copytree(R.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(R.ROOT / "go_mp3_tpu_torch", root / "go_mp3_tpu_torch")
    b = bench()
    cfg = json.loads((R.HERE / "configs" / "fma_clips.json").read_text())
    cfg.update(name="fma_low", bitrate_mix={"128": 1.0}, lowpass_hz={"128": 17000})
    (root / "benchmark/configs/fma_low.json").write_text(json.dumps(cfg))
    (root / "benchmark/workloads/fma.lowrate.json").write_text(json.dumps(
        {"name": "fma.lowrate", "driver": "corpus", "batch_clips": 2, "fetch": True,
         "check_clips": 1, "check_span_frames": 2}))
    (root / "benchmark/metrics/granules_per_call.corpus.py").write_text(
        "def read(r):\n    return r['audio_s'] / len(r['per_call'])\n")
    b["configs"].append({"name": "fma_low", "source": "s", "file":
                         "benchmark/configs/fma_low.json", "reduced": [], "why": "w"})
    b["workloads"].append({"name": "fma.lowrate", "config": "fma_low",
                           "traffic": "lowrate", "chips": 1, "why": "w"})
    b["end_to_end"][0]["workloads"].append("fma.lowrate")
    b["per_layer"].append({"name": "granules_per_call.corpus", "unit": "s",
                           "better": "higher", "source": "program_counter",
                           "layer": "corpus driver", "moves": "corpus_xrt",
                           "workloads": ["fma.lowrate"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    sizes = {**SIZES["fma_clips"], "bitrate_mix": {"128": 1.0}}
    code = f"""
import argparse, json, sys, time
sys.path.insert(0, {str(root)!r})
from benchmark import run as R
assert R.ROOT == __import__('pathlib').Path({str(root)!r})
b = json.loads((R.ROOT / 'BENCHMARK.json').read_text())
out = []
for trace in (0, 1):
    args = argparse.Namespace(workload='fma.lowrate', seed=5, seconds=0.5, trace=trace)
    o = R.run(args, b, R.cell_of(b, 'fma.lowrate'), 'cpu', time.perf_counter(), {sizes!r})
    out.append(R.result_line(o, None))
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"corpus_xrt", "setup_s"}
    assert "granules_per_call.corpus" in traced["metrics"]
    for name in ("run.py", "drivers/corpus.py", "configs/fma_clips.json"):
        assert (root / "benchmark" / name).read_bytes() == (R.HERE / name).read_bytes()


@pytest.mark.parametrize("trace", [0, 1])
def test_host_use_is_read_around_each_call_and_the_window(trace):
    out = run_cell("fma.fetch", trace=trace)
    keys = {"wall", "thread_cpu", "user", "sys", "steal"}
    assert out["per_call"] and all(keys | {"parse"} <= set(c) for c in out["per_call"])
    use = out["host_use"]
    assert set(use) == keys
    assert sum(c["wall"] for c in out["per_call"]) <= use["wall"] <= sum(out["op_s"]) + 0.01
    assert 0 < use["thread_cpu"] <= use["wall"] + 0.05


def test_no_card_no_result(tmp_path):
    """Without CUDA the run exits with another code than 0 and prints no
    result."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, str(R.HERE / "run.py"), "--workload", "fma.fetch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, env=env,
                         cwd=tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_only_the_benchmark_is_no_checkout(card, tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, the
    run exits with another code than 0 and prints no result."""
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "player.seek",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fma.fetch", "player.seek", "fma.ondevice", "player.read"])
def test_cell_on_the_card(card, cell):
    res = subprocess.run([sys.executable, str(R.HERE / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS + ["breakdown", "compared"]
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
