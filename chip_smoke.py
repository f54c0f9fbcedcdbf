#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (go_mp3_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from go_mp3_tpu_torch/csrc, then runs six phases
and exits non-zero at the first that fails:

 1. device: the card (nvidia-smi name and power limit), the kernel build,
    the C++ parser build;
 2. kernels against plain: K1, K2 and K3 each against its plain PyTorch
    version on the same seeded synthetic batch (S=64 streams x T=240
    granules, every block class, stereo mode and band variant, ragged valid
    counts including 0), within stated bounds, and timed against it;
 3. chunk invariance: the same granules decoded as one chunk and split at
    other boundaries, state carried: bit-identical PCM and state;
 4. Decoder: a 94 s stream (conformance/synthetic_escape.mp3 x300) read
    whole and after a seek, against the exact C++ backend, ISO full
    compliance (RMS < 0.289 LSB, max diff <= 2), and a checkpoint/resume;
 5. corpus: decode_corpus_fast over 64 rotated lanes (48 x escape x128,
    16 x lowrate x110: 193,216 granules, ~52 min of audio), every lane ISO
    fully compliant against the exact backend, run cold and warm, with the
    phase split and the launch count of every kernel;
 6. the last line: {"ok": true, "device": {...}}.

The line before the last is a JSON object with one entry per kernel. The
script imports torch, the port (go_mp3_tpu_torch, whose `reference` module
gives the exact C++ backend and the ISO measure) and the seeded-granule
helper tests/torch_synthetic.py; never jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 2026
S_SMOKE, T_SMOKE = 64, 240

KERNEL_ROWS = {  # name -> (source, TPU-side program it replaces)
    "requant_stereo": ("go_mp3_tpu_torch/csrc/requant_stereo.cu",
                       "go_mp3_tpu/ops/granule.py:242"),
    "hybrid": ("go_mp3_tpu_torch/csrc/hybrid.cu",
               "go_mp3_tpu/ops/granule.py:361"),
    "synth": ("go_mp3_tpu_torch/csrc/synth.cu",
              "go_mp3_tpu/ops/granule.py:423"),
}


def say(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Mean milliseconds per call: CUDA events around `iters` calls after a
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def phase_device() -> None:
    import torch

    from go_mp3_tpu_torch import reference
    from go_mp3_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    say(smi.stdout.strip().splitlines()[0])
    say(f"phase 1 device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.load()
    log = _build.library_path().parent / "build.log"
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    for ln in ptxas:
        say(f"  ptxas: {ln}")
    say(f"phase 1 kernel build: {_build.build_seconds:.2f} s nvcc "
        f"({time.perf_counter() - t0:.2f} s load)")
    t0 = time.perf_counter()
    check(reference.native_available(), "the C++ parser (libmp3parse.so) did not build")
    say(f"phase 1 C++ parser build and load: {time.perf_counter() - t0:.2f} s")


def smoke_batch(s_dim: int, t_dim: int, dev):
    """Seeded synthetic chunk on `dev`: both packed interfaces, a ragged
    valid vector (lane 0 empty, lane 1 full), a non-zero state."""
    import torch

    import torch_synthetic as syn
    from go_mp3_tpu_torch.ops.granule import state_from_numpy

    rng = np.random.default_rng(SEED)
    valid = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
    valid[0], valid[1 % s_dim] = 0, t_dim
    sp, sd = syn.random_chunk(SEED, s_dim, t_dim, valid)
    p16 = tuple(torch.from_numpy(a).to(dev) for a in (sp, sd))
    p8 = tuple(torch.from_numpy(a).to(dev) for a in syn.to_packed8(sp, sd))
    state = state_from_numpy(
        (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((s_dim, 2, 16, 64)) * 0.05).astype(np.float32),
        dev,
    )
    return p16, p8, torch.from_numpy(valid).to(dev), state, valid


def _rel(err, scale) -> float:
    """max of err / scale, entry by entry; where the scale is 0 the error
    must be 0."""
    check(bool((err[scale == 0] == 0).all()), "nonzero error on a zero input")
    return float((err / scale.clamp_min(1e-30)).max())


def _rel_per_granule(got, ref) -> float:
    """max |got - ref| over each granule / that granule's max |ref|."""
    return _rel((got - ref).abs().flatten(2).amax(-1), ref.abs().flatten(2).amax(-1))


def phase_kernels(dev, s_dim: int, t_dim: int) -> dict:
    """K1, K2, K3 against their plain versions on the same inputs."""
    import torch

    from go_mp3_tpu_torch.ops import granule as G
    from go_mp3_tpu_torch.ops import kernels as K

    p16, p8, valid, state, _ = smoke_batch(s_dim, t_dim, dev)
    rows = {}

    # K1, both interfaces: requantize alone (2e-5 of the granule's scale,
    # test_stage_parity's bound), then the stereo part on the kernel's own
    # requantized input (1e-6)
    for label, packed in (("int8", p8), ("int16", p16)):
        b = G.batch_from_any(packed)
        k_req, k_ginfo = K.requant_stereo(packed, stereo=False)
        ref_req, ref_ginfo = G.requant_stereo_ref(b, stereo=False)
        check(torch.equal(k_ginfo, ref_ginfo), f"K1 {label}: ginfo differs")
        e_req = _rel_per_granule(k_req, ref_req)
        k_x, _ = K.requant_stereo(packed)
        e_st = _rel_per_granule(k_x, G._stereo(b, k_req))
        ref_x, ginfo = G.requant_stereo_ref(b)
        e_all = _rel_per_granule(k_x, ref_x)
        say(f"phase 2 K1 requant_stereo [{label}]: requant rel {e_req:.3e} "
            f"(<= 2e-5), stereo rel {e_st:.3e} (<= 1e-6), whole rel {e_all:.3e}")
        check(e_req <= 2e-5 and e_st <= 1e-6 and e_all <= 2e-5, f"K1 {label} bound")
        if label == "int8":
            x, x_ginfo = ref_x, ginfo
            rows["requant_stereo"] = {
                "max_abs_err": float((k_x - ref_x).abs().max()),
                "ms": time_ms(lambda: K.requant_stereo(p8)),
                "plain_ms": time_ms(
                    lambda: G.requant_stereo_ref(G.batch_from_any(p8))),
            }

    # K2: 2e-6 (the IMDCT bound of test_stage_parity) of the scale of what
    # each output sums, per (stream, granule, channel): that granule's lines
    # and the previous granule's (the incoming store at t = 0). The new
    # store is the upper half of granule valid-1, or the old store if 0.
    ginfo = x_ginfo
    k_x18, k_store = K.hybrid(x, ginfo, state.store, valid)
    ref_x18, ref_store = G.hybrid_ref(x, ginfo, state.store, valid)
    cur = x.abs().amax(-1)  # [S, T, 2]
    old = state.store.abs().flatten(2).amax(-1)  # [S, 2]
    scale = torch.maximum(cur, torch.cat([old[:, None], cur[:, :-1]], 1))
    e_x18 = _rel((k_x18 - ref_x18).abs().flatten(3).amax(-1), scale)
    last = cur[torch.arange(s_dim, device=dev), (valid.long() - 1).clamp_min(0)]
    st_scale = torch.where((valid > 0)[:, None], last, old)
    e_st = _rel((k_store - ref_store).abs().flatten(2).amax(-1), st_scale)
    say(f"phase 2 K2 hybrid: x18 {e_x18:.3e}, store {e_st:.3e} of each "
        f"granule's input scale (<= 2e-6)")
    check(e_x18 <= 2e-6 and e_st <= 2e-6, "K2 bound")
    rows["hybrid"] = {
        "max_abs_err": float((k_x18 - ref_x18).abs().max()),
        "ms": time_ms(lambda: K.hybrid(x, ginfo, state.store, valid)),
        "plain_ms": time_ms(lambda: G.hybrid_ref(x, ginfo, state.store, valid)),
    }

    # K3 on synthesis-scale input (x18 ~ N(0, 0.3^2), as test_stage_parity
    # feeds its polyphase check): PCM within 1 LSB, state 1e-6 relative
    rng = np.random.default_rng(SEED + 1)
    x18 = torch.from_numpy(
        (rng.standard_normal(ref_x18.shape) * 0.3).astype(np.float32)).to(dev)
    fifo = state.v_fifo * 6.0
    k_pcm, k_fifo = K.synth(x18, ginfo, fifo, valid)
    ref_pcm, ref_fifo = G.synth_ref(x18, ginfo, fifo, valid)
    d_pcm = int((k_pcm.int() - ref_pcm.int()).abs().max())
    e_fifo = float((k_fifo - ref_fifo).abs().max() / ref_fifo.abs().max())
    say(f"phase 2 K3 synth: PCM max diff {d_pcm} LSB (<= 1), state rel "
        f"{e_fifo:.3e} (<= 1e-6)")
    check(d_pcm <= 1 and e_fifo <= 1e-6, "K3 bound")
    # and on the synthetic chain's own x18, up to ~1e4 x full scale, where
    # f32 rounding alone moves samples by several LSB (test_synth_parity's
    # white-noise bounds: RMS < 0.289, max <= 72)
    c_pcm, _ = K.synth(ref_x18, ginfo, state.v_fifo, valid)
    r_pcm, _ = G.synth_ref(ref_x18, ginfo, state.v_fifo, valid)
    dd = (c_pcm.int() - r_pcm.int()).double()
    rms, mx = float(dd.pow(2).mean().sqrt()), int(dd.abs().max())
    say(f"phase 2 K3 synth on chain output: RMS {rms:.4f} LSB (< 0.289), "
        f"max {mx} (<= 72)")
    check(rms < 0.289 and mx <= 72, "K3 chain-output bound")
    rows["synth"] = {
        "max_abs_err": float(d_pcm),
        "ms": time_ms(lambda: K.synth(x18, ginfo, fifo, valid)),
        "plain_ms": time_ms(lambda: G.synth_ref(x18, ginfo, fifo, valid)),
    }
    for name, r in rows.items():
        say(f"phase 2 time {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms (S={s_dim}, T={t_dim})")
    return rows


def phase_chunk_invariance(dev, s_dim: int, t_dim: int) -> None:
    """One chunk vs the same granules split at other boundaries."""
    import torch

    from go_mp3_tpu_torch.ops.granule import DecodeState
    from go_mp3_tpu_torch.ops.kernels import decode_chunk

    _, p8, valid_d, state0, valid = smoke_batch(s_dim, t_dim, dev)
    whole, st_whole = decode_chunk(p8, state0, valid_d)
    splits = (
        (0, t_dim * 2 // 5, t_dim),
        tuple(range(0, t_dim, 64)) + (t_dim,),
        (0, 1, 19, t_dim),
    )
    for bounds in splits:
        st = DecodeState(*state0)
        pieces = []
        for lo, hi in zip(bounds, bounds[1:]):
            v = np.clip(valid - lo, 0, hi - lo).astype(np.int32)
            part = tuple(a[:, lo:hi].contiguous() for a in p8)
            pcm, st = decode_chunk(part, st, torch.from_numpy(v).to(dev))
            pieces.append((pcm, v))
        for s in range(s_dim):
            got = torch.cat([p[s, : v[s] * 576] for p, v in pieces])
            check(torch.equal(got, whole[s, : valid[s] * 576]),
                  f"chunk split {bounds}: PCM of stream {s} differs")
        check(torch.equal(st.store, st_whole.store)
              and torch.equal(st.v_fifo, st_whole.v_fifo),
              f"chunk split {bounds}: state differs")
    say(f"phase 3 chunk invariance: splits {splits} give bit-identical PCM "
        f"and state ({int(valid.sum())} granules)")


def _iso(a: bytes, b: bytes, what: str) -> tuple[float, int]:
    from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, iso_metrics

    rms, mx = iso_metrics(a, b)
    check(rms < FULL_RMS and mx <= FULL_MAXDIFF,
          f"{what}: not ISO full compliance (RMS {rms}, max {mx})")
    return rms, mx


def phase_decoder(dev, times: int = 300) -> None:
    import torch

    from go_mp3_tpu_torch import Decoder, reference

    data = (ROOT / "conformance" / "synthetic_escape.mp3").read_bytes() * times
    t0 = time.perf_counter()
    d = Decoder(data, device=dev)
    pcm = d.read_all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    secs = len(pcm) / 4 / d.sample_rate()
    check(len(pcm) == d.length(), "Decoder: read_all length != length()")
    rms, mx = _iso(pcm, reference.decode_exact(data), "Decoder read_all")
    seek_to = min(30.0, d.duration() / 2)
    n = 4 * d.sample_rate() * 5
    reads = []
    for dec in (d, reference.exact_decoder(data)):
        dec.seek_to_time(seek_to)
        reads.append((dec.tell(), dec.read(n)))
    check(reads[0][0] == reads[1][0] and len(reads[0][1]) == len(reads[1][1]) > 0,
          "Decoder seek: position or length differs")
    srms, smx = _iso(reads[0][1], reads[1][1], "Decoder after seek")
    ck = d.checkpoint_bytes()  # state on the card -> bytes -> a new Decoder
    rest = d.read(n)
    d2 = Decoder(data, device=dev)
    d2.resume_bytes(ck)
    check(d2.checkpoint_bytes() == ck and d2.read(n) == rest,
          "Decoder checkpoint/resume did not round-trip")
    say(f"phase 4 Decoder: {secs:.2f} s of audio in {wall:.3f} s "
        f"({secs / wall:.1f}x realtime, one stream); vs exact RMS {rms:.4f} "
        f"max {mx}; seek_to_time({seek_to}) + 5 s read RMS {srms:.4f} max "
        f"{smx}; checkpoint/resume round-trips")


def corpus_lanes(n_escape: int = 48, n_lowrate: int = 16,
                 escape_times: int = 128, lowrate_times: int = 110) -> list[bytes]:
    """Rotated lanes, each starting at a different frame (as bench.py
    builds its corpus)."""
    from go_mp3_tpu_torch.reference import index_stream

    def rotated(data: bytes, n: int, step: int) -> list[bytes]:
        starts, _, _ = index_stream(data)
        out = []
        for s in range(n):
            off = int(starts[(1 + step * s) % len(starts)])
            out.append(data[off:] + data[:off])
        return out

    escape = (ROOT / "conformance" / "synthetic_escape.mp3").read_bytes() * escape_times
    lowrate = (ROOT / "conformance" / "synthetic_lowrate.mp3").read_bytes() * lowrate_times
    return rotated(escape, n_escape, 29) + rotated(lowrate, n_lowrate, 43)


def phase_corpus(dev, lanes: list[bytes], chunk_t: int = 240) -> dict:
    """Two runs: the first pays one-time set-up (pinned host buffers, the
    caching allocator, module loading), the second is the steady state.
    Both must give the same bytes; the second is checked lane by lane."""
    import torch

    from go_mp3_tpu_torch import decode_corpus_fast
    from go_mp3_tpu_torch.reference import decode_exact, index_stream

    runs = []
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = decode_corpus_fast(lanes, chunk_t=chunk_t, device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**20
        runs.append((label, res, wall, peak))
    check(runs[0][1].pcm == runs[1][1].pcm, "corpus: two runs gave different PCM")
    rates = [index_stream(d)[2] for d in lanes]
    res = runs[1][1]
    audio = sum(len(p) / 4 / sr for p, sr in zip(res.pcm, rates))
    with ThreadPoolExecutor(max_workers=8) as pool:
        refs = list(pool.map(decode_exact, lanes))
    worst = (0.0, 0)
    for i, (got, ref) in enumerate(zip(res.pcm, refs)):
        rms, mx = _iso(got, ref, f"corpus lane {i}")
        worst = (max(worst[0], rms), max(worst[1], mx))
    say(f"phase 5 corpus: {len(lanes)} lanes, {res.granules} granules, "
        f"{audio:.2f} s of audio; every lane ISO full vs exact (worst RMS "
        f"{worst[0]:.4f}, max {worst[1]})")
    for label, r, wall, peak in runs:
        ph = r.phase_seconds
        card = ph["h2d"] + ph["kernels"] + ph["d2h"]
        say(f"phase 5 corpus {label}: wall {wall:.3f} s -> {audio / wall:.1f}x "
            f"realtime; host: parse {ph['parse']:.3f} s, emit {ph['emit']:.3f} "
            f"s; card, overlapping the host: h2d {ph['h2d']:.4f} s, kernels "
            f"{ph['kernels']:.4f} s, d2h {ph['d2h']:.4f} s, busy "
            f"{100 * card / wall:.1f}% of the wall; peak device memory "
            f"{peak:.0f} MiB")
    return {"granules": res.granules, "audio_s": audio, "runs": runs}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "go_mp3_tpu_torch").is_dir() or not (ROOT / "conformance").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

    from go_mp3_tpu_torch.device import resolve_device
    from go_mp3_tpu_torch.ops import kernels as K

    dev = resolve_device(None)
    phase_device()
    rows = phase_kernels(dev, S_SMOKE, T_SMOKE)
    phase_chunk_invariance(dev, S_SMOKE, T_SMOKE)

    K.reset_launch_counts()  # the main path's run starts here
    phase_decoder(dev)
    after_decoder = K.launch_counts()
    phase_corpus(dev, corpus_lanes())
    counts = K.launch_counts()
    say(f"launches: Decoder {after_decoder}, Decoder + corpus {counts}")
    check(all(n > 0 for n in after_decoder.values()), "a kernel never ran in the Decoder")
    check(all(counts[k] > after_decoder[k] for k in counts), "a kernel never ran in the corpus")
    check(not any(m == "jax" or m.startswith(("jax.", "go_mp3_tpu.ops"))
                  for m in sys.modules), "jax or go_mp3_tpu.ops was imported")

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_ROWS[name][0],
         "replaces": KERNEL_ROWS[name][1], "launches": counts[name], **rows[name]}
        for name in KERNEL_ROWS
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
