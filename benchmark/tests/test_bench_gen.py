"""The generator: valid Layer III frames that fill their bit budget, made
the same from the same seed, within the port's int8 interface."""

import io
import json

import numpy as np
import pytest

from benchmark.gen import mp3gen, traffic
from benchmark.reference.consts import EOFError_
from benchmark.reference.parser import FrameReader
from benchmark.reference.source import Source

from cell_sizes import SIZES

KW = dict(lowpass_hz=19500, short_share=0.1, mixed_share=0.03, ms_share=0.85,
          loudness_rms=0.012)


def _parse(data):
    src, fr, out = Source(io.BytesIO(data)), FrameReader(), []
    while True:
        try:
            out.append(fr.read(src, src.pos))
        except EOFError_:
            return out


@pytest.mark.parametrize("bitrate", [128, 192, 256, 320])
def test_frames_parse_to_what_was_written_and_fill_the_budget(bitrate):
    rng = np.random.default_rng(bitrate)
    data, starts, gcs = mp3gen.make_run_fields(rng, bitrate, 40, run_frames=20, **KW)
    frames = _parse(data)
    assert len(frames) == 40
    assert [f.start_position for f in frames] == list(starts[:-1])
    assert {g["kind"] for g in gcs} >= {mp3gen.LONG, mp3gen.SHORT}
    used = 0
    for f, fr in enumerate(frames):
        assert fr.header.bitrate == bitrate * 1000
        assert fr.side_info.main_data_begin <= mp3gen.MAX_MDB
        if f % 20 == 0:  # a run starts with its own reservoir
            assert fr.side_info.main_data_begin == 0
        for gr in range(2):
            for ch in range(2):
                g = gcs[4 * f + 2 * gr + ch]
                np.testing.assert_array_equal(fr.main_data.is_[gr][ch], g["q"])
                assert fr.side_info.part2_3_length[gr][ch] == g["part23"]
                assert fr.side_info.global_gain[gr][ch] == g["gg"]
                used += g["part23"]
    budget = 8 * sum(starts[i + 1] - starts[i] - 36 for i in range(40))
    assert 0.95 <= used / budget <= 1.0


def test_clips_are_the_same_from_the_same_seed():
    from benchmark.run import ROOT

    cfg = json.loads((ROOT / "benchmark/configs/fma_clips.json").read_text())
    wl = {"batch_clips": 4}
    cfg.update(SIZES["fma_clips"], catalogue_clips=8)
    a = traffic.clip_batches(cfg, wl, 2 ** 40 + 3)
    b = traffic.clip_batches(cfg, wl, 2 ** 40 + 3)
    c = traffic.clip_batches(cfg, wl, 2 ** 40 + 4)
    assert [[s.data for s in x] for x in a] == [[s.data for s in x] for x in b]
    assert [[s.data for s in x] for x in a] != [[s.data for s in x] for x in c]
    # another seed, the same sizes: frames and bitrates per batch
    for x, y in zip(a, c):
        assert sorted((s.bitrate, s.frames) for s in x) == sorted((s.bitrate, s.frames) for s in y)


def test_bitrate_counts_keep_the_mix():
    counts = traffic.bitrate_counts({"320": 0.75, "256": 0.0834, "192": 0.0833,
                                     "128": 0.0833}, 128)
    assert counts == {320: 96, 256: 11, 192: 11, 128: 10}


def test_clips_stay_in_the_ports_int8_interface():
    from go_mp3_tpu_torch.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH
    from go_mp3_tpu_torch.native.lib import BatchParser

    rng = np.random.default_rng(11)
    runs = mp3gen.make_runs(rng, 320, 4, 24, **{**KW, "short_share": 0.3,
                                                  "mixed_share": 0.1})
    streams = [r[0] for r in runs]
    bp = BatchParser(streams)
    t = 64
    arrays = (np.zeros((4, t, SP8_TAIL_WIDTH), np.int8), np.zeros((4, t, HEAD_WIDTH), np.int16),
              np.zeros((4, t, SIDE8_WIDTH), np.uint8), np.zeros(4, np.int32))
    total = 0
    try:
        while True:
            bp.parse_chunk_into(*arrays)  # raises OverflowError past int8
            if not arrays[3].any():
                break
            total += int(arrays[3].sum())
    finally:
        bp.close()
    assert total == 4 * 24 * 2
