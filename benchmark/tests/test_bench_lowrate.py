"""The fma_lowrate configuration and its cell fma.lowrate, on the CPU: the
low-rate writer's frames are what MPEG-1 at 32 kHz and MPEG-2 LSF joint
stereo at 24 kHz are, each filling its budget, within the port's int8
interface and the same sizes from every seed; a batch holds 43/43/42 clips
of the three rungs; the cell runs correct, and not correct when its answers
are broken or when the reference runs in TF32 in the program's place; its
traced run reports slot_fill_pct.lowrate, and none on a port without the
counter of slots."""

import argparse
import io
import json
from collections import Counter

import numpy as np
import pytest

from benchmark import roofline
from benchmark import run as R
from benchmark.check import Compared
from benchmark.drivers.corpus import lane_offsets
from benchmark.gen import mp3gen_rates, traffic
from benchmark.reference import decode as reference
from benchmark.reference.consts import SF_BAND_INDICES, EOFError_, Layer, Mode, Version
from benchmark.reference.parser import FrameReader
from benchmark.reference.source import Source

from cell_sizes import bench
from test_bench_faults import _altered, _half_lanes_silent

CELL = "fma.lowrate"
SIZES = {"catalogue_clips": 6, "batch_clips": 3, "clip_seconds": 3,
         "pool": {"runs_per_bitrate": 2, "frames_per_run": 16}, "check_clips": 1}
NEW = ("slot_fill_pct.lowrate",)
APPENDED = ("parse_s_per_h.corpus", "pack_s_per_h.corpus", "copy_s_per_h.corpus",
            "chain_roofline_pct.corpus", "device_idle_pct.corpus",
            "wire_bytes_per_granule.corpus")
FORMATS = {"mpeg1_32k": (mp3gen_rates.MPEG1_32K, 96, Version.MPEG1, 432, 32),
           "mpeg2_24k": (mp3gen_rates.MPEG2_24K, 64, Version.MPEG2, 192, 17)}


@pytest.fixture(autouse=True)
def _fresh_spans():
    """The port's span totals cleared around each test: a traced run reads
    them, and a later test in this process must not read this one's."""
    from go_mp3_tpu_torch import spans

    spans.reset()
    yield
    spans.reset()


def _config(**sizes) -> dict:
    cfg = json.loads((R.HERE / "configs" / "fma_lowrate.json").read_text())
    cfg.update(**sizes)
    return cfg


def _run_fields(name: str, seed: int, n_frames: int = 96, run_frames: int = 32, **kw):
    fmt, br = FORMATS[name][:2]
    cfg = _config()
    args = dict(lowpass_hz=cfg["lowpass_hz"][str(br)], short_share=cfg["short_share"],
                mixed_share=0.0 if fmt.lsf else cfg["mixed_share"],
                ms_share=cfg["ms_share"], loudness_rms=cfg["loudness_rms"])
    return mp3gen_rates.make_run_fields(np.random.default_rng(seed), fmt, br, n_frames,
                                        run_frames=run_frames, **{**args, **kw})


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


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_band_tables_are_the_references(name):
    fmt = FORMATS[name][0]
    long_bands, short_bands = SF_BAND_INDICES[fmt.lsf][fmt.sfreq]
    assert fmt.long_bands == long_bands and fmt.short_bands == short_bands


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_frames_are_of_their_version_rate_and_size(name, seed):
    fmt, br, version, size, side_bytes = FORMATS[name]
    data, starts, gcs, ms = _run_fields(name, seed)
    frames = _parse(data)
    assert len(frames) == 96 and len(gcs) == 96 * 2 * fmt.granules
    assert set(np.diff(starts)) == {size}  # CBR, never padded
    assert size == (144 if version == Version.MPEG1 else 72) * br * 1000 // fmt.sample_rate
    for f, fr in enumerate(frames):
        h, si = fr.header, fr.side_info
        assert (h.version, h.layer, h.sampling_frequency_value(), h.mode, h.bitrate,
                h.protection_bit) == (version, Layer.LAYER3, fmt.sample_rate,
                                     Mode.JOINT_STEREO, br * 1000, 1)
        assert h.use_ms_stereo == bool(ms[f]) and not h.use_intensity_stereo
        assert h.side_info_size == side_bytes and h.granules == fmt.granules
        assert si.main_data_begin <= fmt.max_mdb
        if f % 32 == 0:  # a run starts with its own reservoir
            assert si.main_data_begin == 0
        for gr in range(fmt.granules):
            for ch in range(2):
                g = gcs[2 * fmt.granules * f + 2 * gr + ch]
                np.testing.assert_array_equal(fr.main_data.is_[gr][ch], g["q"])
                assert si.part2_3_length[gr][ch] == g["part23"]
    assert 0.75 < np.mean(ms) < 0.95


@pytest.mark.parametrize("seed", [4, 2 ** 40 + 9])
@pytest.mark.parametrize("name", sorted(FORMATS))
def test_each_frame_fills_its_budget(name, seed):
    """A frame's main data starts right after the last frame's, or as far
    back as the reservoir reaches (main_data_begin 511 or 255); over the
    runs, the frames use 0.85-1.05 of their bits."""
    fmt = FORMATS[name][0]
    data, starts, gcs, ms = _run_fields(name, seed)
    frames = _parse(data)
    per = 2 * fmt.granules
    slot = np.diff(starts) - 4 - fmt.side_info_bytes
    pos = np.concatenate([[0], np.cumsum(slot)])
    end = 0
    for f, fr in enumerate(frames):
        mdb = fr.side_info.main_data_begin
        start = pos[f] - mdb
        if f % 32:
            assert mdb == fmt.max_mdb or start == -(-end // 8), f
        end = 8 * start + sum(g["part23"] for g in gcs[per * f:per * (f + 1)])
        assert end <= 8 * (pos[f] + slot[f])
    used = sum(g["part23"] for g in gcs) / (8 * slot.sum())
    assert 0.85 <= used <= 1.05, used


@pytest.mark.parametrize("name", sorted(FORMATS))
def test_tails_stay_in_the_ports_int8_interface(name):
    """Lines from per-channel line 64 after the reorder within int8, the head
    above it; the port's int8 parse takes the streams whole."""
    from go_mp3_tpu_torch.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
    from go_mp3_tpu_torch.native.lib import BatchParser

    fmt = FORMATS[name][0]
    data, starts, gcs, ms = _run_fields(name, 5, n_frames=128, short_share=0.3)
    q = np.abs(np.stack([g["q"] for g in gcs]))
    short = np.array([g["kind"] in (mp3gen_rates.SHORT, mp3gen_rates.MIXED) for g in gcs])
    assert short.any() and q[:, :64].max() > 127
    assert q[~short, 64:].max() <= 127 and q[short, fmt.tail_from_short():].max() <= 127
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
    assert total == 128 * fmt.granules


def test_batches_are_the_same_sizes_from_every_seed():
    """The cell's own sizes: every batch of 128 holds 43 clips at 128 kbps
    (2,298 granules), 43 at 96 (1,668) and 42 at 64 (1,250), 223,038
    granules in 9 chunks of 256 granule slots: 75.6% of the slots filled."""
    cfg = _config()
    wl = {"batch_clips": 128}
    a = mp3gen_rates.clip_batches(cfg, wl, 2 ** 40 + 3)
    c = mp3gen_rates.clip_batches(cfg, wl, 2 ** 40 + 4)
    assert len(a) == len(c) == 2
    for x, y in zip(a, c):
        assert [s.data for s in x] != [s.data for s in y]
        for batch in (x, y):
            assert Counter(s.bitrate for s in batch) == {128: 43, 96: 43, 64: 42}
            assert {(s.bitrate, s.sample_rate, s.granules, len(s.data)) for s in batch} == {
                (128, 44100, 2298, 480210), (96, 32000, 1668, 360288), (64, 24000, 1250, 240000)}
            assert sum(s.granules for s in batch) == 223038
            assert all(abs(s.seconds - 30) < 0.03 for s in batch)
        assert sorted(len(s.data) for s in x) == sorted(len(s.data) for s in y)
    assert [s.bitrate for s in a[0]] != [s.bitrate for s in c[0]]  # the order is the seed's
    assert 100 * 223038 / (9 * 128 * 256) == pytest.approx(75.6, abs=0.05)


def test_stream_work_is_its_frames_work():
    """A clip's chain work, counted from the fields written, is the work of
    its parsed frames (both channels, MS where the frame has it), on each
    rung."""
    cfg = _config(**{k: v for k, v in SIZES.items() if k != "check_clips"})
    batch = mp3gen_rates.clip_batches(cfg, {"batch_clips": 3}, 7)[0]
    assert {s.sample_rate for s in batch} == {44100, 32000, 24000}
    for s in batch:
        frames = reference._frames(s.data, 0, None)
        ops = nbytes = 0.0
        for f in frames:
            si, md = f.side_info, f.main_data
            ng = f.header.granules
            short = np.array([[si.win_switch_flag[g][c] == 1 and si.block_type[g][c] == 2
                               for c in range(2)] for g in range(ng)])
            mixed = short & (np.array(si.mixed_block_flag[:ng]) == 1)
            ms = np.array([f.header.use_ms_stereo] * ng)
            ops += roofline.granule_ops(np.asarray(md.is_[:ng]), short, mixed, ms).sum()
            nbytes += roofline.granule_bytes(np.array(si.part2_3_length[:ng])).sum()
        assert len(frames) == s.frames
        assert s.ops == pytest.approx(ops, rel=1e-12)
        assert s.nbytes == pytest.approx(nbytes, rel=1e-12)


def test_cell_is_an_entry_with_its_metrics():
    b = bench()
    cell = R.cell_of(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("fma_lowrate", "lowrate", 1)
    assert b["workloads"][-1] == cell
    e2e, layer = R.metrics_of(b, cell)
    assert {m["name"] for m in e2e} == {"corpus_xrt", "setup_s"}
    assert {m["name"] for m in layer} == set(NEW + APPENDED)
    got = {m["name"]: m for m in b["per_layer"]}
    assert list(got)[-1] == "slot_fill_pct.lowrate"
    assert got["slot_fill_pct.lowrate"] == {
        "name": "slot_fill_pct.lowrate", "unit": "%", "better": "higher",
        "source": "program_counter", "layer": "corpus driver", "moves": "corpus_xrt",
        "workloads": [CELL]}
    for name in APPENDED:
        assert got[name]["workloads"][-1] == CELL
    entry = b["configs"][-1]
    assert (entry["name"], entry["reduced"]) == ("fma_lowrate", ["catalogue_clips"])
    cfg = _config()
    assert cfg["source_values"] == {"catalogue_clips": 106574}
    assert sum(("quoted from memory" in a) for a in cfg["assumed"]) == 2
    assert len(entry["source"]) <= 200 and cfg["source"] == entry["source"]


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(trace):
    out = _run(trace)
    assert out["correct"], out["compared"].numbers()
    assert out["compared"].answers == 1 + 3 and out["failed"] == 0
    line = R.result_line(out, None)
    if not trace:
        assert set(line["metrics"]) == {"corpus_xrt", "setup_s"}
        return
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(got) == set(NEW + APPENDED) - {"chain_roofline_pct.corpus"}  # no card
    # a batch of one clip a rung: 230, 168 and 125 granules in one chunk of 256
    assert got["slot_fill_pct.lowrate"] == pytest.approx(100 * (230 + 168 + 125) / (3 * 256))


@pytest.mark.parametrize("fault", ["answer_altered", "silent_lanes"])
def test_broken_answers_are_not_correct(fault, monkeypatch):
    if fault == "answer_altered":
        from go_mp3_tpu_torch.ops import kernels

        monkeypatch.setattr(kernels, "chain", _altered(kernels.chain))
        sizes = {}
    else:  # half of a batch silent at the right length, no clip compared whole
        from go_mp3_tpu_torch import parallel

        monkeypatch.setattr(parallel, "decode_corpus_fast",
                            _half_lanes_silent(parallel.decode_corpus_fast))
        sizes = {"catalogue_clips": 6, "batch_clips": 6, "clip_seconds": 2, "check_clips": 0}
    out = _run(**sizes)
    n = out["compared"].numbers()
    assert not out["correct"], n
    assert n["length_mismatches"]["value"] == 0
    assert n["max_abs_lsb"]["value"] > 10 * n["max_abs_lsb"]["limit"]


def test_control_is_not_correct():
    """The reference in TF32 in the program's place, on the answers a run
    compares (two whole clips, a 4-granule span of each clip of a batch,
    each decoded at its own frame): not correct, by more than 3x each
    limit."""
    cfg = _config(catalogue_clips=6, clip_seconds=3,
                  pool={"runs_per_bitrate": 2, "frames_per_run": 16})
    batches = mp3gen_rates.clip_batches(cfg, {"batch_clips": 3}, 2 ** 33 + 5)
    rng = traffic.rng_for(2 ** 33 + 5, 4)
    nbytes = 4 * mp3gen_rates.BYTES_PER_GRANULE_PCM
    out = Compared(cfg["guarantee"]["limits"])
    for s in (batches[0][0], batches[1][2]):
        out.add(reference.decode(s.data, precision="tf32"), reference.decode(s.data))
    for s, off in zip(batches[0], lane_offsets(rng, batches[0], nbytes)):
        args = (s.data, off, nbytes, s.starts, s.frame_pcm_bytes)
        out.add(reference.pcm_span(*args, precision="tf32"), reference.pcm_span(*args))
    n = out.numbers()
    assert not out.ok()
    assert n["max_abs_lsb"]["value"] > 3 * n["max_abs_lsb"]["limit"]
    assert n["rms_lsb"]["value"] > 3 * n["rms_lsb"]["limit"]


def test_without_the_slots_counter_no_slot_fill(monkeypatch):
    """The port as a commit before the counter of slots: the reader gives
    None, and the run its other metrics."""
    from go_mp3_tpu_torch import spans

    count = spans.count
    monkeypatch.setattr(spans, "count", lambda name, n=1: None if name == "gomp3.corpus.slots"
                        else count(name, n))
    out = _run(trace=1)
    assert out["correct"]
    assert "wire_bytes_per_granule.corpus" in out["metrics"]
    assert not set(out["metrics"]) & set(NEW)
