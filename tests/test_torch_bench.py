"""The port's bench (go_mp3_tpu_torch/bench.py), its corpus program
(parallel/corpus_scan.py), the energy kernel's plain version and CUDA source,
and the two bench tools, on the CPU, held against bench.py and the JAX
package.

Small corpus: corpus_lanes(3, 2, escape_times=3, lowrate_times=3) (three
stereo lanes of 72 granules, two mono lanes of 78), chunk_t 32: 3 chunks
(an odd count, so the pipelined schedule pads one), both lane groups, sums
far from wrapping.
- geometry: n_chunks, granules per lane, audio seconds, per-chunk tail
  caps, wire bytes, the corpus-global width and the equal-width runs equal
  bench.py's, computed by its code with go_mp3_tpu.native.lib and
  go_mp3_tpu.parallel.corpus on the same lanes;
- the corpus program against bench.py's (unpack_fused(_mono), the vmapped
  decode_chunk_packed8_impl, lax.scan, the energy of bench.py:416-418) on
  the same fused bytes: PCM of every chunk ISO full, final states within
  test_torch_granule.STATE_REL (1e-6 of their scale, inside
  test_stage_parity.py's bounds), the port's energies equal to numpy's
  wrapped int32 sum of its own PCM bit for bit;
- energy_ref equal to JAX's energy bit for bit, -32768 and a wrapping sum
  included; the energy kernel's CUDA source (csrc/energy.cu) through the
  CPU emulation of tests/cuda_emu/ bit for bit against energy_ref, and a
  mutant that drops each row's last word caught;
- all four schedules give equal energies and the same final state (so the
  pipelined padding chunk, valid 0, leaves the state as it was);
- main(["--device", "cpu"]) prints one JSON line with bench.py's keys as
  the port changes them; without --device it raises where CUDA is absent;
- bench_compare's diff prints what tools/bench_compare.py prints; the parse
  probe's granule and chunk counts equal the JAX package parser's.
"""

import importlib.util
import io
import json
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import go_mp3_tpu.ops.granule as JG  # noqa: E402
from go_mp3_tpu_torch import bench  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.parallel.corpus_scan import decode_energies  # noqa: E402
from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS  # noqa: E402
from go_mp3_tpu_torch.tools import bench_compare, parse_corpus_bench  # noqa: E402
from go_mp3_tpu_torch.tools.corpus import corpus_lanes  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N_ESCAPE, N_LOWRATE, CHUNK_T = 3, 2, 32
SETTINGS = bench.Settings(n_escape=N_ESCAPE, n_lowrate=N_LOWRATE, chunk_t=CHUNK_T,
                          run_budget_s=0.0)


def _small_lanes() -> list[bytes]:
    return corpus_lanes(N_ESCAPE, N_LOWRATE, escape_times=3, lowrate_times=3)


@pytest.fixture(scope="module")
def lanes():
    return _small_lanes()


@pytest.fixture(scope="module")
def setup(lanes):
    b = bench.Bench(lanes, SETTINGS, CPU)
    assert b.geo.n_chunks % 2 == 1 and len(b.groups) == 2
    return b


def _jax_geometry(lanes, chunk_t, n_stereo, buckets):
    """bench.py:179-201, :205-266, :312 and :333-338, with its imports."""
    from go_mp3_tpu.native.lib import (
        HEAD_WIDTH,
        SIDE8_WIDTH,
        SP8_TAIL_WIDTH,
        BatchParser,
        NativeParser,
    )
    from go_mp3_tpu.parallel.corpus import tail_cap_lines

    n_streams = len(lanes)
    spp = np.zeros((chunk_t, SP8_TAIL_WIDTH), np.int8)
    escp = np.zeros((chunk_t, HEAD_WIDTH), np.int16)
    sdp = np.zeros((chunk_t, SIDE8_WIDTH), np.uint8)
    gr_by_stream, sr_by_stream = [], []
    n_chunks = 0
    for data in lanes:
        p = NativeParser(data)
        total, calls = 0, 0
        while True:
            n = p.parse_packed8_into(spp, escp, sdp)
            if n == 0:
                break
            total += n
            calls += 1
        gr_by_stream.append(total)
        sr_by_stream.append(p.sample_rate)
        n_chunks = max(n_chunks, calls)
        p.close()
    audio_secs = sum(g * 576 / sr for g, sr in zip(gr_by_stream, sr_by_stream))
    pool = [(np.empty((n_streams, chunk_t, SP8_TAIL_WIDTH), np.int8),
             np.empty((n_streams, chunk_t, HEAD_WIDTH), np.int16),
             np.empty((n_streams, chunk_t, SIDE8_WIDTH), np.uint8)) for _ in range(n_chunks)]
    bp = BatchParser(lanes)
    for spectra, head, side in pool:
        bp.parse_chunk_into(spectra, head, side, np.zeros(n_streams, np.int32))
    bp.close()
    widths = [(tail_cap_lines(sp[:n_stereo], buckets), tail_cap_lines(sp[n_stereo:], buckets))
              for sp, _, _ in pool]
    wire_bytes = sum(n_stereo * JG.fused_stream_nbytes(chunk_t, w[0])
                     + (n_streams - n_stereo) * JG.fused_stream_nbytes_mono(chunk_t, w[-1])
                     for w in widths)
    w_glob = tuple(max(w[g] for w in widths) for g in range(len(widths[0])))
    runs_idx, lo = [], 0
    for c in range(1, n_chunks + 1):
        if c == n_chunks or widths[c] != widths[lo]:
            runs_idx.append((widths[lo], lo, c))
            lo = c
    return dict(n_chunks=n_chunks, granules=tuple(gr_by_stream), audio=audio_secs,
                widths=widths, wire_bytes=wire_bytes, w_glob=w_glob, runs=runs_idx)


def test_geometry_equals_bench_py(lanes, setup):
    want = _jax_geometry(lanes, CHUNK_T, N_ESCAPE, SETTINGS.tail_buckets)
    assert setup.geo.n_chunks == want["n_chunks"]
    assert setup.geo.granules == want["granules"]
    assert setup.geo.audio_seconds == want["audio"]
    assert setup.widths == want["widths"]
    assert setup.wire_bytes == want["wire_bytes"]
    assert setup.w_glob == want["w_glob"]
    assert setup.runs == want["runs"]


def _wire(setup, c):
    """Chunk c's fused rows as the bench packs them (per-chunk widths)."""
    setup.pack(c, setup.host_np[c], setup.widths[c])
    return [a.copy() for a in setup.host_np[c]]


def _parsed_valids(setup):
    valids = np.zeros((setup.geo.n_chunks, len(setup.lanes)), np.int32)
    bench.parse_sample(setup.lanes, setup.pool, valids)
    return valids


def _wrapped_energy(pcm: np.ndarray) -> np.ndarray:
    """numpy's int32 sum of |int32(pcm)| over each lane, wrapping."""
    return np.abs(pcm.astype(np.int32)).sum(axis=(1, 2), dtype=np.int32)


def test_corpus_program_matches_bench_py_program(setup):
    from go_mp3_tpu.parallel.mesh import init_states

    valids = _parsed_valids(setup)
    wires = [_wire(setup, c) for c in range(setup.geo.n_chunks)]
    groups, n = setup.groups, len(setup.lanes)

    # the port's program, eager on the CPU, every chunk's PCM kept
    pcm = {}
    energies = torch.zeros(valids.shape, dtype=torch.int32)
    states = decode_energies(
        [[torch.from_numpy(a) for a in w] for w in wires], torch.from_numpy(valids),
        [P.init_state(g.hi - g.lo, CPU) for g in groups], energies, groups, CHUNK_T,
        setup.widths, [torch.empty((g.hi - g.lo, CHUNK_T * 576, 2), dtype=torch.int16)
                       for g in groups],
        on_pcm=lambda c, g, x: pcm.__setitem__((c, g), x.numpy().copy()))
    port_pcm = [np.concatenate([pcm[c, g] for g in range(len(groups))])
                for c in range(len(wires))]

    # bench.py's make_decode (:378-429), also returning the PCM it reduces
    def unpack_chunk(bufs, w):
        parts = [(JG.unpack_fused_mono if g.mono else JG.unpack_fused)(
            jnp.asarray(b), CHUNK_T, wg) for g, b, wg in zip(groups, bufs, w)]
        return tuple(jnp.concatenate([p[i] for p in parts]) for i in range(3))

    tails = [unpack_chunk(b, w) for b, w in zip(wires, setup.widths)]
    xs = tuple(jnp.stack([x[i] for x in tails]) for i in range(3)) + (jnp.asarray(valids),)
    batched = jax.vmap(JG.decode_chunk_packed8_impl)

    @jax.jit
    def scan(xs, st):
        def step(st, x):
            ta, he, sd, v = x
            out, st = batched(ta, he, sd, st, v)
            return st, (jnp.sum(jnp.abs(out.astype(jnp.int32)), axis=(1, 2)), out)
        return jax.lax.scan(step, st, xs)

    j_states, (j_energies, j_pcm) = scan(xs, init_states(n))
    j_pcm = np.asarray(j_pcm)

    for c, got in enumerate(port_pcm):
        d = got.astype(np.float64) - j_pcm[c]
        assert np.sqrt((d ** 2).mean()) < FULL_RMS and np.abs(d).max() <= FULL_MAXDIFF, c
        # the energies are the port's own PCM's, bit for bit
        np.testing.assert_array_equal(energies[c].numpy(), _wrapped_energy(got))
    # bench.py's energies are its own PCM's too (the same reduction)
    np.testing.assert_array_equal(np.asarray(j_energies),
                                  [_wrapped_energy(p) for p in j_pcm])
    from test_torch_granule import STATE_REL
    for j, g in enumerate(groups):
        got = P.state_to_numpy(states[j])
        for ref, x in zip((j_states.store, j_states.v_fifo), got):
            ref = np.asarray(ref)[g.lo:g.hi]
            assert np.abs(ref - x).max() <= STATE_REL * np.abs(ref).max()


@pytest.mark.parametrize("case", ["random", "extremes", "wrap"])
def test_energy_ref_equals_jax_energy(case):
    rng = np.random.default_rng({"random": 1, "extremes": 2, "wrap": 3}[case])
    if case == "random":
        x = rng.integers(-32768, 32768, (4, 576, 2)).astype(np.int16)
        x[0, 0, 0] = -32768
    elif case == "extremes":  # -32768 everywhere in one lane, 32767 in another
        x = np.stack([np.full((96, 2), -32768), np.full((96, 2), 32767),
                      rng.integers(-3, 4, (96, 2))]).astype(np.int16)
    else:  # 240 granules at full scale: 9.06e9 wraps past 2^31 (bench.py:641-646)
        x = rng.choice(np.array([-32768, 32767], np.int16), (2, 240 * 576, 2))
    want = np.asarray(jnp.sum(jnp.abs(jnp.asarray(x).astype(jnp.int32)), axis=(1, 2)))
    got = P.energy_ref(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "wrap":
        assert (np.abs(x.astype(np.int64)).sum(axis=(1, 2)) > 2**31).all()


def test_energy_wrapper_checks_its_input():
    from go_mp3_tpu_torch.ops import kernels as K

    x = torch.zeros((2, 8, 2), dtype=torch.int16)
    with pytest.raises(TypeError):
        K.energy(x.int())
    with pytest.raises(ValueError):
        K.energy(x, out=torch.zeros(3, dtype=torch.int32))
    out = torch.ones(2, dtype=torch.int32)
    assert K.energy(x, out=out) is out and not out.any()


@pytest.mark.parametrize("mutate", [False, True])
def test_energy_cuda_source_on_the_cpu_emulation(mutate, tmp_path):
    """csrc/energy.cu built with g++ against tests/cuda_emu/cuda_runtime.h
    and run through kernels.energy's CUDA route: bit for bit against
    energy_ref (exit 0); the mutant that drops the last word of each row
    must differ (exit 1)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ for the CUDA emulation")
    cmd = [sys.executable, str(ROOT / "tests" / "cuda_emu" / "emulate.py"),
           "--kernels", "energy", "--build-dir", str(tmp_path)]
    if mutate:
        cmd += ["--mutate", "energy.cu", "i < words ?", "i < words - 1 ?"]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode == (1 if mutate else 0), p.stdout + p.stderr
    assert ("DIFFERS" in p.stdout) == mutate


def test_schedules_agree_and_padding_keeps_the_state(setup):
    results = {}
    for mode in bench.SCHEDULES:
        _, _, en = setup.one_run(mode)
        results[mode] = (en, [tuple(t.clone() for t in st) for st in setup.states])
    base_en, base_st = results["strict"]
    assert (base_en != 0).any()
    for mode, (en, st) in results.items():
        np.testing.assert_array_equal(en, base_en, err_msg=mode)
        for a, b in zip(st, base_st):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), mode
    # the pipelined program alone: its last chunk pads (valid 0) and the
    # state after it is the state after the last real chunk
    assert setup.n_even == setup.geo.n_chunks + 1
    assert not setup.valids_host[-1].any()


def test_main_prints_the_json_line(monkeypatch):
    monkeypatch.setenv("GOMP3_N_CLASSIC", str(N_ESCAPE))
    monkeypatch.setenv("GOMP3_N_MPEG2", str(N_LOWRATE))
    monkeypatch.setenv("GOMP3_CHUNK_T", str(CHUNK_T))
    monkeypatch.setenv("GOMP3_RUN_BUDGET_S", "0")
    monkeypatch.setattr(bench, "corpus_lanes", lambda n_escape, n_lowrate: _small_lanes())
    buf = io.StringIO()
    with redirect_stdout(buf):
        run = bench.main(["--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert r == run.result
    assert set(r) == {"metric", "value", "unit", "detail"} and r["value"] > 0
    d = r["detail"]
    for key in ("decoder_ceiling_x_realtime", "decoder_ceiling_fused_x_realtime",
                "decoder_ceiling_pipelined_x_realtime", "parse_full_corpus_cpu_s",
                "end_to_end_x_by_schedule", "probe_compute_s_per_chunk_scan_amortized",
                "probe_scan_total_s", "tail_cap_lines_per_chunk", "runs_wall_s",
                "transfers_per_corpus_by_schedule", "d2h_mb_s", "host_cores", "device",
                "card", "capture_s"):
        assert key in d, key
    assert "vs_baseline" not in r and "d2h_tunnel_mb_s" not in d
    assert d["device"] == "cpu" and d["card"] is None and d["capture_s"] == 0.0
    assert all(len(w) >= 2 for w in d["runs_wall_s"].values())
    assert set(d["runs_wall_s"]) == set(bench.SCHEDULES)
    assert d["n_chunks"] == run.energies.shape[0] == run.valids.shape[0]
    assert int(run.valids.sum()) == d["granules"]
    assert "synthetic_escape.mp3" in d["corpus"]


def test_main_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench.main([])


def test_settings_from_env_are_bench_pys():
    s = bench.Settings.from_env({})
    assert (s.n_escape, s.n_lowrate, s.chunk_t, s.tail_buckets, s.mono_split) == \
        (48, 16, 240, (464, 512), True)
    assert s.schedules == bench.SCHEDULES and s.run_budget_s == 300.0
    s = bench.Settings.from_env({"GOMP3_SCHEDULES": "pipelined,strict", "GOMP3_TAIL_BUCKETS": "",
                                 "GOMP3_MONO_SPLIT": "0"})
    assert s.schedules == ("strict", "pipelined") and s.tail_buckets is None
    assert not s.mono_split


def _load_original(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_compare_diff_equals_the_original(tmp_path, monkeypatch):
    baseline = {"metric": "m", "unit": "u", "value": 1000.0,
                "detail": {"a": 1, "b": [2, 3], "gone": 4}}
    current = {"metric": "m", "unit": "u", "value": 1234.5,
               "detail": {"a": 2, "b": [2, 3], "new": None}}
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps(baseline))
    original = _load_original("jax_tools_bench_compare", ROOT / "tools" / "bench_compare.py")
    monkeypatch.setattr(original.subprocess, "run", lambda *a, **k: types.SimpleNamespace(
        stdout=json.dumps(current) + "\n"))
    monkeypatch.setattr(sys, "argv", ["bench_compare.py", str(path)])
    buf = io.StringIO()
    with redirect_stdout(buf):
        original.main()
    assert bench_compare.diff(baseline, current) == buf.getvalue().splitlines()
    assert bench_compare.main([str(tmp_path / "missing.json")]) == 1


def test_parse_probe_counts_equal_the_jax_parser(lanes):
    p = parse_corpus_bench.probe(lanes, CHUNK_T, 2)
    want = _jax_geometry(lanes, CHUNK_T, N_ESCAPE, SETTINGS.tail_buckets)
    assert p["granules"] == sum(want["granules"]) and p["n_chunks"] == want["n_chunks"]
    assert p["audio_seconds"] == want["audio"]
    assert len(p["cpu_s"]) == len(p["wall_s"]) == 2
    line = parse_corpus_bench.summary(p)
    assert "ceiling" not in line and f"({p['granules']} gr, {p['n_chunks']} chunks)" in line
    assert "ceiling-at-0.5s-compute (computed)" in parse_corpus_bench.summary(p, 0.5)
