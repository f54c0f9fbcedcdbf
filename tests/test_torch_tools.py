"""The port's tools (go_mp3_tpu_torch/tools/) on the CPU, each held against
its original in tools/ or example/ on the same inputs.

- compliance: _stereo, find_best_alignment and compare equal
  tools/compliance.py's on seeded PCM shifted by 0, +137 and -420 samples
  with +-1 noise (offset and histogram equal, RMS within 1e-12); main on
  the device backend (CPU) against exact: FULL; an --oracle-cmd that
  prints the exact PCM (exit 0), that PCM + 3 LSB (1, limited) and + 40
  LSB (2, fail).
- bench_single: run_one's bytes_out equals the exact Decoder's; without
  CUDA the default device raises.
- profile_device: the variants' computations at S = 2, T = 16 on CPU
  tensors (the kernels' wrappers run their plain versions) against the JAX
  computations of tools/profile_device.py's v_unpack, v_requant, v_imdct
  and v_full, rebuilt from the same go_mp3_tpu.ops.granule calls on the
  same parsed granules, eagerly and per stream: the unpack sum exact,
  requantize+stereo sums within 2e-5 and the IMDCT's within 2e-6 of the
  sum of |values| (test_stage_parity.py's bounds), |PCM| within 1 LSB per
  sample; the timing entry raises without CUDA.
- profile_decode: the cProfile names parse_stream_granules; summarize on a
  hand-made trace; a CPU trace of one 16-granule chunk is a Chrome trace.
- example: the WAV header equals example/main.py's, its data the Decoder's
  PCM.
- fuzz_soak: 8 mutants per fixture, no mismatch.
"""

import importlib.util
import json
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import go_mp3_tpu.ops.granule as JG  # noqa: E402
from go_mp3_tpu_torch import Decoder  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.tools import (  # noqa: E402
    bench_single,
    compliance,
    example,
    fuzz_soak,
    profile_decode,
    profile_device,
)
from go_mp3_tpu_torch.tools.corpus import ESCAPE  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _load(name: str, path: Path):
    """A module of tools/ or example/, loaded by path under its own name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_COMPLIANCE = _load("jax_tools_compliance", ROOT / "tools" / "compliance.py")
JAX_EXAMPLE = _load("jax_example_main", ROOT / "example" / "main.py")


# -- compliance -----------------------------------------------------------------


@pytest.mark.parametrize("shift", [0, 137, -420])
def test_alignment_and_compare_equal_the_original(shift):
    rng = np.random.default_rng(1000 + shift)
    # audio-like: white noise low-passed (two 128-tap moving averages), so
    # that the coarse search's 50-sample grid sees the alignment
    box = np.ones(128) / 128
    ref_pcm = np.stack([np.convolve(np.convolve(rng.standard_normal(30_000), box, "same"),
                                    box, "same") for _ in range(2)], 1)
    ref_pcm = (ref_pcm * 8000 / np.abs(ref_pcm).max()).astype("<i2")
    ref = ref_pcm.astype(np.int32)
    test = (np.concatenate([np.zeros((shift, 2), np.int32), ref]) if shift >= 0
            else ref[-shift:].copy())
    test = test + rng.integers(-1, 2, test.shape)
    test_pcm = test.astype("<i2").tobytes()
    assert np.array_equal(compliance._stereo(test_pcm), JAX_COMPLIANCE._stereo(test_pcm))
    assert np.array_equal(compliance._stereo(ref_pcm.tobytes()), ref)
    found = compliance.find_best_alignment(ref, test)
    assert found == JAX_COMPLIANCE.find_best_alignment(ref, test) == shift
    got, want = compliance.compare(ref, test, found), JAX_COMPLIANCE.compare(ref, test, found)
    assert abs(got.pop("rms") - want.pop("rms")) <= 1e-12
    assert got == want and len(got["histogram_top10"]) == 3  # diffs -1, 0, +1
    assert got["limited"] and not got["full"]  # RMS of the noise ~0.82 LSB


def test_main_device_against_exact_is_full(capsys):
    rc = compliance.main([str(ESCAPE), "--device", "cpu", "--backend", "device",
                          "--oracle-backend", "exact", "--json"])
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and result["verdict"] == "FULL COMPLIANCE" and result["offset"] == 0
    assert result["device"] == "cpu" and result["total_samples"] > 0


@pytest.mark.parametrize("delta, rc, verdict", [
    (0, 0, "FULL COMPLIANCE"), (3, 1, "LIMITED COMPLIANCE"), (40, 2, "FAIL")])
def test_oracle_cmd_verdicts(tmp_path, capsys, delta, rc, verdict):
    """An external oracle that prints the exact backend's PCM plus `delta`
    LSB on every sample; the backend under test is exact, on the host."""
    exact = np.frombuffer(Decoder(ESCAPE.read_bytes(), backend="exact").read_all(), "<i2")
    pcm = tmp_path / "oracle.pcm"
    pcm.write_bytes(np.clip(exact.astype(np.int32) + delta, -32768, 32767)
                    .astype("<i2").tobytes())
    script = tmp_path / "oracle.py"
    script.write_text("import sys\n"
                      f"sys.stdout.buffer.write(open({str(pcm)!r}, 'rb').read())\n")
    cmd = f"{shlex.quote(sys.executable)} {shlex.quote(str(script))}"
    got = compliance.main([str(ESCAPE), "--backend", "exact", "--oracle-cmd", cmd, "--json"])
    result = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert got == rc and result["verdict"] == verdict and result["offset"] == 0
    assert result["oracle"] == cmd and result["device"] == "cpu"


# -- bench_single ---------------------------------------------------------------


def test_bench_single_exact_row():
    data = ESCAPE.read_bytes() * 2
    row = bench_single.run_one(data, "exact", reps=1)
    assert row["bytes_out"] == len(Decoder(data, backend="exact").read_all()) > 0
    assert row["bytes_in"] == len(data) and row["device"] == "cpu"
    assert {"backend", "compressed_mb_s", "x_realtime", "ms_per_file"} <= set(row)
    dev = bench_single.run_one(data, "device", reps=1, device="cpu")
    assert dev["bytes_out"] == row["bytes_out"] and dev["device"] == "cpu"


def test_bench_single_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_single.run_one(ESCAPE.read_bytes(), "device", reps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_single.main(["--backend", "exact"])


# -- profile_device -------------------------------------------------------------

S_DIM, T_DIM = 2, 16
REQUANT_REL, IMDCT_REL = 2e-5, 2e-6  # tests/test_stage_parity.py


@pytest.fixture(scope="module")
def stages():
    """(the port's variants on CPU tensors, JAX's per stream: sums and
    PCM, eagerly) on the same parsed chunk."""
    c = profile_device.make_chunk(S_DIM, T_DIM, CPU)
    port = profile_device.run_variants(c)
    arrays = tuple(map(jnp.asarray, profile_device.parse_chunk(T_DIM)))
    jb = JG.batch_from_packed8(*arrays)
    state = JG.init_state()
    x = JG._stereo(jb, JG._requantize(jb))
    out18, _ = JG._overlap_fold(JG._imdct(jb, JG._antialias(jb, x)), state.store)
    pcm, _ = JG.decode_chunk_packed8_impl(*arrays, state, jnp.int32(T_DIM))
    jax = {"unpack": np.asarray(jb.spectra), "requant": np.asarray(x),
           "imdct": np.asarray(out18), "pcm": np.asarray(pcm)}
    return c, port, jax


def _sum_within(got: torch.Tensor, want: np.ndarray, rel: float) -> None:
    """Per stream: |sum(got) - sum(want)| <= rel * sum(|want|)."""
    scale = np.abs(want.astype(np.float64)).sum()
    assert scale > 0
    for s in range(S_DIM):
        d = abs(float(got[s].double().sum()) - float(want.astype(np.float64).sum()))
        assert d <= rel * scale, (s, d, scale)


def test_profile_device_unpack_matches_jax(stages):
    _, port, jax = stages
    b = P.batch_from_packed8(*port["unpack (K4)"])
    for s in range(S_DIM):
        assert int(b.spectra[s].long().sum()) == int(jax["unpack"].astype(np.int64).sum())


@pytest.mark.parametrize("name", ["+requant+stereo (K1, int8)", "+requant+stereo (K1, wire)"])
def test_profile_device_requant_matches_jax(stages, name):
    _, port, jax = stages
    _sum_within(port[name][0], jax["requant"], REQUANT_REL)


def test_profile_device_imdct_matches_jax(stages):
    """K2 applies the frequency inversion (signs +-1) that JAX's v_imdct
    sums without: undone exactly before the sum."""
    _, port, jax = stages
    x18, _ = port["+aa+imdct+overlap (K1 -> K2)"]
    _sum_within(x18 * P._tables(CPU).freq_inv, jax["imdct"], IMDCT_REL)


@pytest.mark.parametrize("name", ["full chunk (K5)", "full chunk (K1 -> K2 -> K3)"])
def test_profile_device_full_chunk_matches_jax(stages, name):
    _, port, jax = stages
    pcm, _ = port[name]
    want = np.abs(jax["pcm"].astype(np.int64))
    for s in range(S_DIM):
        got = np.abs(pcm[s].numpy().astype(np.int64))
        assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_profile_device_timing_needs_cuda(stages, monkeypatch):
    c, _, _ = stages
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_device.time_variants(c, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_device.main(["--s", "2", "--t", "16"])


# -- profile_decode -------------------------------------------------------------


def test_host_profile_names_the_python_parse():
    assert "parse_stream_granules" in profile_decode.host_profile(ESCAPE.read_bytes())
    r = profile_decode.parse_interfaces(ESCAPE.read_bytes() * 2, rounds=1)
    assert r["granules"] == 48 and set(r["seconds"]) == {
        "index_stream (headers)", "parse_into", "parse_packed_into", "parse_packed8_into"}


def test_summarize_a_hand_made_trace():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        ev("user_annotation", profile_decode.WINDOW, 1000.0, 100.0),
        ev("cpu_op", "outer", 999.0, 102.0),
        ev("cpu_op", "sync", 1035.0, 15.0),
        ev("cpu_op", "emit", 1055.0, 40.0),
        ev("kernel", "void chain_kernel<4>(Inputs)", 1010.0, 20.0),
        ev("kernel", "void chain_kernel<4>(Inputs)", 1025.0, 10.0),  # overlaps
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1050.0, 10.0),
        ev("kernel", "other", 1090.0, 20.0),  # runs past the window's end
        ev("kernel", "chain_kernel", 2000.0, 5.0),  # outside the window
        {"ph": "i", "name": "marker", "ts": 1001.0},
    ]
    s = profile_decode.summarize(events)
    assert s["window_us"] == 100.0 and s["busy_us"] == 45.0 and s["busy_share"] == 0.45
    assert s["chain_events"] == 2
    assert list(s["by_name"]) == ["void chain_kernel<4>(Inputs)", "other",
                                  "Memcpy HtoD (Pinned -> Device)"]
    assert s["by_name"]["void chain_kernel<4>(Inputs)"] == {"cat": "kernel", "count": 2,
                                                            "us": 30.0}
    assert [(g["start_us"], g["us"], g["host_op"]) for g in s["gaps"]] == [
        (60.0, 30.0, "emit"), (35.0, 15.0, "sync"), (0.0, 10.0, profile_decode.WINDOW)]
    # the host's own time in each gap, of the events inside the window
    assert [g["host_self"] for g in s["gaps"]] == [[["emit", 30.0]], [["sync", 15.0]], []]
    s = profile_decode.summarize(events + [ev("python_function", "pack", 1070.0, 10.0)])
    assert s["gaps"][0]["host_op"] == "emit"
    assert s["gaps"][0]["host_self"] == [["emit", 20.0], ["pack", 10.0]]


def test_cpu_trace_of_a_chunk_is_a_chrome_trace(tmp_path):
    fn = profile_decode.chunk_window(ESCAPE.read_bytes(), 16, CPU)
    w = profile_decode.trace_window("chunk", fn, CPU, tmp_path)
    trace = json.loads((tmp_path / "chunk.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert profile_decode.WINDOW in names and w["trace"] == str(tmp_path / "chunk.json")
    assert w["busy_share"] == 0.0 and w["chain_events"] == w["chain_launches"] == 0
    assert w["window_us"] > 0 and w["gaps"][0]["us"] == w["window_us"]
    assert "Self CPU time total" in w["table"]


# -- example and fuzz_soak ------------------------------------------------------


@pytest.mark.parametrize("n, rate", [(0, 44100), (16_588_800, 44100), (4 * 576, 22050)])
def test_wav_header_equals_the_original(n, rate):
    assert example.wav_header(n, rate) == JAX_EXAMPLE.wav_header(n, rate)


def test_example_writes_the_decoders_pcm(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "simpleaudio", None)  # no audio stack
    dst = tmp_path / "out.wav"
    assert example.main([str(ESCAPE), str(dst), "--device", "cpu"]) == 0
    pcm = Decoder(ESCAPE.read_bytes(), device="cpu").read_all()
    wav = dst.read_bytes()
    assert wav[:44] == JAX_EXAMPLE.wav_header(len(pcm), 44100) and wav[44:] == pcm


def test_fuzz_soak_eight_mutants(capsys):
    assert fuzz_soak.main(["8"]) == 0
    assert capsys.readouterr().out.startswith("OK: ")
