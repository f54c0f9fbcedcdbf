"""The speech_lsf configuration and its cell speech_lsf.ondevice, on the CPU:
the LSF writer's frames are what MPEG-2 LSF mono at 48 kbps is, the same
sizes from every seed and within the port's int8 interface; the cell runs
correct, and not correct when its answers are broken or when the reference
runs in TF32 in the program's place; its traced run reports the wire
builder's new metrics, and none of them on a port without the counters."""

import argparse
import io
import json
import sys
import types

import numpy as np
import pytest

from benchmark import run as R
from benchmark.check import Compared
from benchmark.drivers.corpus import lane_offsets
from benchmark.gen import mp3gen_lsf, traffic
from benchmark.reference import decode as reference
from benchmark.reference.consts import SF_BAND_INDICES, EOFError_, Layer, Mode, Version
from benchmark.reference.parser import FrameReader
from benchmark.reference.source import Source

from cell_sizes import bench
from test_bench_faults import _altered, _half_lanes_silent

CELL = "speech_lsf.ondevice"
SIZES = {"catalogue_tracks": 4, "batch_clips": 2, "track_frames": 120,
         "pool": {"runs_per_bitrate": 2, "frames_per_run": 16}, "check_clips": 1}
NEW = ("mono_wire_pct.lsf", "wire_bytes_per_granule.corpus")
APPENDED = ("parse_s_per_h.corpus", "pack_s_per_h.corpus", "copy_s_per_h.corpus",
            "chain_roofline_pct.corpus", "device_idle_pct.corpus")


def _config(**sizes) -> dict:
    cfg = json.loads((R.HERE / "configs" / "speech_lsf.json").read_text())
    cfg.update(**sizes)
    return cfg


def _run_fields(seed: int, n_frames: int = 96, run_frames: int = 32, **kw):
    cfg = _config()
    args = dict(lowpass_hz=cfg["lowpass_hz"], short_share=cfg["short_share"],
                fricative_share=cfg["fricative_share"], pause_share=cfg["pause_share"],
                loudness_rms=cfg["loudness_rms"], pause_rms=cfg["pause_rms"])
    return mp3gen_lsf.make_run_fields(np.random.default_rng(seed), cfg["bitrate_kbps"],
                                      n_frames, run_frames=run_frames, **{**args, **kw})


def _parse(data):
    src, fr, out = Source(io.BytesIO(data)), FrameReader(), []
    while True:
        try:
            out.append(fr.read(src, src.pos))
        except EOFError_:
            return out


def _run(trace: int = 0, seed: int = 2 ** 31 + 7, **sizes) -> dict:
    b = bench()
    args = argparse.Namespace(workload=CELL, seed=seed, seconds=1.0, trace=trace)
    return R.run(args, b, R.cell_of(b, CELL), "cpu", R.time.perf_counter(),
                 {**SIZES, **sizes})


def test_band_tables_are_the_references():
    long_bands, short_bands = SF_BAND_INDICES[1][0]  # MPEG-2, 22.05 kHz
    assert tuple(mp3gen_lsf.LONG_BANDS) == long_bands
    assert tuple(mp3gen_lsf.SHORT_BANDS) == short_bands


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_frames_are_mpeg2_lsf_mono_at_48_kbps(seed):
    data, starts, gcs = _run_fields(seed)
    frames = _parse(data)
    assert len(frames) == len(gcs) == 96
    sizes = np.diff(starts)
    assert set(sizes) == {156, 157}
    assert abs(sizes.mean() - 72 * 48000 / 22050) < 0.05  # CBR: 156.73 B a frame
    for f, fr in enumerate(frames):
        h, si = fr.header, fr.side_info
        assert (h.version, h.layer, h.sampling_frequency_value(), h.mode, h.bitrate,
                h.protection_bit) == (Version.MPEG2, Layer.LAYER3, 22050, Mode.SINGLE_CHANNEL,
                                     48000, 1)
        assert h.side_info_size == 9 and h.granules == 1
        assert si.main_data_begin <= mp3gen_lsf.MAX_MDB
        if f % 32 == 0:  # a run starts with its own reservoir
            assert si.main_data_begin == 0
        assert si.preflag[0][0] == int(si.scalefac_compress[0][0] >= 500)
        np.testing.assert_array_equal(fr.main_data.is_[0][0], gcs[f]["q"])
        assert si.part2_3_length[0][0] == gcs[f]["part23"]


@pytest.mark.parametrize("seed", [4, 2 ** 40 + 9])
def test_each_frame_fills_its_budget(seed):
    """The bits a frame leaves go to the reservoir: between one frame's main
    data and the next there is stuffing (past the byte) only where the
    reservoir is full, main_data_begin 255; pauses leave such bits."""
    data, starts, gcs = _run_fields(seed)
    frames = _parse(data)
    slot = np.diff(starts) - 13
    pos = np.concatenate([[0], np.cumsum(slot)])
    end, full = 0, 0
    for f, fr in enumerate(frames):
        mdb = fr.side_info.main_data_begin
        start = pos[f] - mdb
        if f % 32:
            assert mdb == mp3gen_lsf.MAX_MDB or start == -(-end // 8), f
            full += mdb == mp3gen_lsf.MAX_MDB
        end = 8 * start + gcs[f]["part23"]
    assert full > 0
    speech = [f for f, g in enumerate(gcs) if not g["pause"]]
    pauses = [f for f, g in enumerate(gcs) if g["pause"]]
    assert len(pauses) == 3 * round(0.15 * 32)
    used = sum(gcs[f]["part23"] for f in speech) / (8 * slot[speech].sum())
    assert 0.85 <= used <= 1.2
    assert sum(gcs[f]["part23"] for f in pauses) < 0.15 * 8 * slot[pauses].sum()


def test_tails_stay_in_the_ports_int8_interface():
    """Lines from per-channel line 64 after the reorder (54 in the bitstream
    order of a short block) within int8, the head above it; the port's
    int8 parse takes the streams whole."""
    from go_mp3_tpu_torch.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
    from go_mp3_tpu_torch.native.lib import BatchParser

    data, starts, gcs = _run_fields(5, n_frames=128, short_share=0.3)
    q = np.abs(np.stack([g["q"] for g in gcs]))
    short = np.array([g["kind"] == mp3gen_lsf.SHORT for g in gcs])
    assert short.any() and q[:, :64].max() > 127
    assert q[~short, 64:].max() <= 127 and q[short, 54:].max() <= 127
    bp = BatchParser([data])
    arrays = (np.zeros((1, 64, SP8_TAIL_WIDTH), np.int8), np.zeros((1, 64, HEAD_WIDTH), np.int16),
              np.zeros((1, 64, SIDE8_WIDTH), np.uint8), np.zeros(1, np.int32))
    total = 0
    try:
        while True:
            bp.parse_chunk_into(*arrays)  # raises OverflowError past int8
            if not arrays[3].any():
                break
            total += int(arrays[3].sum())
    finally:
        bp.close()
    assert total == 128


def test_tracks_are_the_same_sizes_from_every_seed():
    cfg = _config(**{k: v for k, v in SIZES.items() if k != "check_clips"})
    wl = {"batch_clips": 2}
    a = mp3gen_lsf.track_batches(cfg, wl, 2 ** 40 + 3)
    b = mp3gen_lsf.track_batches(cfg, wl, 2 ** 40 + 3)
    c = mp3gen_lsf.track_batches(cfg, wl, 2 ** 40 + 4)
    assert [[s.data for s in x] for x in a] == [[s.data for s in x] for x in b]
    assert [[s.data for s in x] for x in a] != [[s.data for s in x] for x in c]
    for x, y in zip(a, c):
        assert [(len(s.data), s.frames, s.pcm_bytes) for s in x] == \
            [(len(s.data), s.frames, s.pcm_bytes) for s in y]
    track = a[0][0]
    assert track.seconds == 120 * 576 / 22050 and track.pcm_bytes == 120 * 2304
    # the fixture's 2,872 frames: 1,654,272 samples, 75.024 s at 22,050 Hz
    assert mp3gen_lsf.Stream(b"", 48, 2872, 0.0, 0.0, []).seconds == 1654272 / 22050


def test_stream_work_is_one_channel_and_stereo_pcm():
    """The chain's work of a track: one channel's operations (no MS), and
    its main data with the stereo PCM written."""
    from benchmark import roofline

    cfg = _config(**{k: v for k, v in SIZES.items() if k != "check_clips"})
    track = mp3gen_lsf.track_batches(cfg, {"batch_clips": 2}, 7)[0][0]
    frames = reference._frames(track.data, 0, None)
    ops = nbytes = 0.0
    for f in frames:
        si = f.side_info
        short = np.array([[si.win_switch_flag[0][0] == 1 and si.block_type[0][0] == 2]])
        ops += roofline.granule_ops(f.main_data.is_[:1, :1], short, np.zeros_like(short),
                                    np.array([False])).sum()
        nbytes += si.part2_3_length[0][0] / 8 + 576 * 4
    assert len(frames) == track.frames
    assert track.ops == pytest.approx(ops, rel=1e-12)
    assert track.nbytes == pytest.approx(nbytes, rel=1e-12)


def test_cell_is_an_entry_with_its_metrics():
    b = bench()
    cell = R.cell_of(b, CELL)
    assert (cell["config"], cell["chips"]) == ("speech_lsf", 1)
    e2e, layer = R.metrics_of(b, cell)
    assert {m["name"] for m in e2e} == {"corpus_xrt", "setup_s"}
    assert {m["name"] for m in layer} == set(NEW + APPENDED)
    got = {m["name"]: m for m in b["per_layer"]}
    assert list(got)[-2:] == list(NEW)
    assert got["wire_bytes_per_granule.corpus"]["workloads"] == [
        "fma.fetch", "fma.ondevice", CELL]
    assert next(c for c in b["configs"] if c["name"] == "speech_lsf")["reduced"] == []


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(trace):
    out = _run(trace)
    assert out["correct"], out["compared"].numbers()
    assert out["compared"].answers == 1 + 2 and out["failed"] == 0
    line = R.result_line(out, None)
    if not trace:
        assert set(line["metrics"]) == {"corpus_xrt", "setup_s"}
        return
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(NEW + APPENDED) - {"chain_roofline_pct.corpus"}  # no card
    assert got["mono_wire_pct.lsf"] == 100.0
    # 120 valid granules in one chunk of 256 slots, a mono row of 808 B a slot
    assert got["wire_bytes_per_granule.corpus"] == pytest.approx(808 * 256 / 120)


@pytest.mark.parametrize("fault", ["answer_altered", "silent_lanes"])
def test_broken_answers_are_not_correct(fault, monkeypatch):
    if fault == "answer_altered":
        from go_mp3_tpu_torch.ops import kernels

        monkeypatch.setattr(kernels, "chain", _altered(kernels.chain))
        sizes = {}
    else:  # half of a batch silent at the right length, no track compared whole
        from go_mp3_tpu_torch import parallel

        monkeypatch.setattr(parallel, "decode_corpus_fast",
                            _half_lanes_silent(parallel.decode_corpus_fast))
        sizes = {"catalogue_tracks": 8, "batch_clips": 8, "track_frames": 60,
                 "check_clips": 0}
    out = _run(**sizes)
    n = out["compared"].numbers()
    assert not out["correct"], n
    assert n["length_mismatches"]["value"] == 0
    assert n["max_abs_lsb"]["value"] > 10 * n["max_abs_lsb"]["limit"]


def test_control_is_not_correct():
    """The reference in TF32 in the program's place, on the answers a run
    compares (two whole tracks, a 4-frame span of each track of a batch):
    not correct, by more than 3x each limit."""
    cfg = _config(catalogue_tracks=8, track_frames=115,
                  pool={"runs_per_bitrate": 2, "frames_per_run": 16})
    batches = mp3gen_lsf.track_batches(cfg, {"batch_clips": 4}, 2 ** 33 + 5)
    rng = traffic.rng_for(2 ** 33 + 5, 4)
    nbytes = 4 * mp3gen_lsf.BYTES_PER_FRAME_PCM
    out = Compared(cfg["guarantee"]["limits"])
    for t in (batches[0][0], batches[1][2]):
        out.add(reference.decode(t.data, precision="tf32"), reference.decode(t.data))
    for t, off in zip(batches[0], lane_offsets(rng, batches[0], nbytes)):
        args = (t.data, off, nbytes, t.starts, mp3gen_lsf.BYTES_PER_FRAME_PCM)
        out.add(reference.pcm_span(*args, precision="tf32"), reference.pcm_span(*args))
    n = out.numbers()
    assert not out.ok()
    assert n["max_abs_lsb"]["value"] > 3 * n["max_abs_lsb"]["limit"]
    assert n["rms_lsb"]["value"] > 3 * n["rms_lsb"]["limit"]


def test_without_the_counters_no_new_metric(monkeypatch):
    """The port as a commit before the counters: the readers give None, the
    run its other metrics."""
    from go_mp3_tpu_torch import spans

    spans.reset()
    monkeypatch.setattr(spans, "_profiler_enabled", lambda: False)
    monkeypatch.setattr(spans, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=False))
    monkeypatch.setitem(sys.modules, "go_mp3_tpu_torch.spans", None)
    out = _run(trace=1)
    assert out["correct"]
    assert out["metrics"] and not set(out["metrics"]) & set(NEW)
