"""MPEG-2 LSF mono speech through the port's corpus path, on the CPU.

The benchmark's LSF writer (benchmark/gen/mp3gen_lsf.py: 22.05 kHz mono,
48 kbps, one granule a frame, LSF scalefactors, an 8-bit reservoir) makes
a small seeded batch; the port's C++ and pure-Python parsers read it alike
and as written; decode_corpus_fast ships every granule on the half-width
mono wire and decodes it within ISO/IEC 11172-4 full accuracy of the
benchmark's plain reference, alone and beside MPEG-1 stereo lanes; and the
reference's span decode (four warm-up frames) is the linear decode's
slice at this format's frame."""

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import go_mp3_tpu.parallel.corpus as JC  # noqa: E402
from benchmark.gen import mp3gen_lsf, traffic  # noqa: E402
from go_mp3_tpu.bitstream import Source as JaxSource  # noqa: E402
from go_mp3_tpu.bitstream.parser import FrameReader as JaxFrameReader  # noqa: E402
from go_mp3_tpu.consts import EOFError_ as JaxEOFError  # noqa: E402
from benchmark.reference import decode as reference  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast, spans  # noqa: E402
from go_mp3_tpu_torch.bitstream import Source  # noqa: E402
from go_mp3_tpu_torch.bitstream.parser import FrameReader  # noqa: E402
from go_mp3_tpu_torch.consts import EOFError_  # noqa: E402
from go_mp3_tpu_torch.models import native_pipeline  # noqa: E402
from go_mp3_tpu_torch.models.pipeline import pack_granule_batch  # noqa: E402
from go_mp3_tpu_torch.ops.granule import GranuleBatch  # noqa: E402
from go_mp3_tpu_torch.parallel.corpus import parse_stream_granules  # noqa: E402
from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, iso_metrics  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 11
CHUNK_T = 64


def _cfg(name: str, **sizes) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text())
    cfg.update(pool={"runs_per_bitrate": 2, "frames_per_run": 16}, **sizes)
    return cfg


@pytest.fixture(scope="module")
def tracks():
    """4 LSF tracks of 3 s (115 frames), composed of runs as the cell's."""
    cfg = _cfg("speech_lsf", catalogue_tracks=4, track_frames=115)
    return mp3gen_lsf.track_batches(cfg, {"batch_clips": 4}, SEED)[0]


@pytest.fixture(scope="module")
def linear(tracks):
    return [reference.decode(t.data) for t in tracks]


@pytest.fixture(scope="module")
def run_fields():
    """One writer run whose fields are kept, for a field-by-field check."""
    rng = np.random.default_rng(SEED)
    cfg = _cfg("speech_lsf")
    return mp3gen_lsf.make_run_fields(
        rng, 48, 48, run_frames=24, lowpass_hz=cfg["lowpass_hz"], short_share=0.2,
        fricative_share=cfg["fricative_share"], pause_share=cfg["pause_share"],
        loudness_rms=cfg["loudness_rms"], pause_rms=cfg["pause_rms"])


def _assert_compliant(got: bytes, want: bytes) -> None:
    assert len(got) == len(want)
    rms, maxdiff = iso_metrics(got, want)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


def _read_frames(data: bytes, source=Source, reader=FrameReader, eof=EOFError_) -> list:
    src, fr, frames = source(io.BytesIO(data)), reader(), []
    while True:
        try:
            frames.append(fr.read(src, src.pos))
        except eof:
            return frames


def test_python_parser_reads_what_was_written(run_fields):
    data, starts, gcs = run_fields
    frames = _read_frames(data)
    assert len(frames) == len(gcs) == 48
    assert {g["kind"] for g in gcs} >= {mp3gen_lsf.LONG, mp3gen_lsf.SHORT}
    assert {g["table"] for g in gcs} == {0, 1, 2}  # every slen table, preflag implied
    for f, (frame, g) in enumerate(zip(frames, gcs)):
        h, si, md = frame.header, frame.side_info, frame.main_data
        assert (h.low_sampling_frequency, h.sampling_frequency_value(), h.number_of_channels,
                h.granules, h.bitrate) == (1, 22050, 1, 1, 48000)
        assert frame.start_position == starts[f]
        assert (si.part2_3_length[0][0], si.big_values[0][0], si.global_gain[0][0],
                si.scalefac_compress[0][0], si.preflag[0][0]) == (
            g["part23"], g["big_values"], g["gg"], g["sfc"], g["preflag"])
        np.testing.assert_array_equal(md.is_[0][0], g["q"])
        if g["kind"] == mp3gen_lsf.SHORT:
            np.testing.assert_array_equal(md.scalefac_s[0][0], g["sf_s"])
        else:
            np.testing.assert_array_equal(md.scalefac_l[0][0], g["sf_l"])


def test_cpp_and_python_parsers_read_the_tracks_alike(tracks):
    for t in tracks:
        arrays, rate = native_pipeline.parse_stream_native(t.data)
        assert rate == 22050
        native, n = native_pipeline.granule_batch_from_native(*arrays)
        python, n_py = pack_granule_batch(parse_stream_granules(t.data))
        assert n == n_py == t.frames
        for name in GranuleBatch._fields:
            assert torch.equal(getattr(native, name), getattr(python, name)), name


def test_jax_parser_reads_the_frames_as_the_port(run_fields, tracks):
    """The JAX package's parser against the port's pure-Python one on the
    writer's run and on every track: header, side info, scalefactors and
    Huffman values field by field, and the same frame positions."""
    for data in [run_fields[0]] + [t.data for t in tracks]:
        port = _read_frames(data)
        jax = _read_frames(data, JaxSource, JaxFrameReader, JaxEOFError)
        assert len(port) == len(jax) > 0
        for a, b in zip(port, jax):
            assert a.start_position == b.start_position
            assert (a.header.low_sampling_frequency, a.header.sampling_frequency_value(),
                    a.header.number_of_channels, a.header.granules, a.header.bitrate) == (
                b.header.low_sampling_frequency, b.header.sampling_frequency_value(),
                b.header.number_of_channels, b.header.granules, b.header.bitrate)
            for part in ("side_info", "main_data"):
                pa, pb = getattr(a, part), getattr(b, part)
                for f in dataclasses.fields(pb):
                    np.testing.assert_array_equal(np.asarray(getattr(pa, f.name)),
                                                  np.asarray(getattr(pb, f.name)), f.name)


@pytest.fixture
def traced():
    spans.reset()
    yield lambda: profile(activities=[ProfilerActivity.CPU])
    spans.reset()


def test_corpus_on_the_mono_wire_within_iso_limits(tracks, linear, traced):
    """fetch=False: every lane within ISO full accuracy of the reference at
    its exact length; the counters: every granule on the mono wire, no
    rerun."""
    with traced():
        pcm, valids = res = decode_corpus_fast([t.data for t in tracks], chunk_t=CHUNK_T,
                                               fetch=False, device="cpu")
    granules = int(valids.sum())
    assert granules == sum(t.frames for t in tracks) == res.stats.granules
    for j, want in enumerate(linear):
        got = b"".join(pcm[c, j, : int(v) * 576].numpy().tobytes()
                       for c, v in enumerate(valids[:, j]))
        _assert_compliant(got, want)
    assert all(len(w) == 1 for w in res.stats.chunk_widths)  # one (mono) group
    assert spans.totals()["counts"] == {"gomp3.corpus.granules": granules,
                                        "gomp3.corpus.slots": valids.size * CHUNK_T,
                                        "gomp3.corpus.mono_granules": granules,
                                        "gomp3.corpus.wire_bytes": res.stats.wire_bytes}


def test_mono_and_stereo_lanes_decode_as_two_groups(tracks, linear, traced):
    """LSF mono lanes beside MPEG-1 stereo ones: a stereo and a mono lane
    group, results in the caller's order, each within the limits."""
    fma = _cfg("fma_clips", catalogue_clips=2, clip_seconds=2, bitrate_mix={"128": 1.0})
    stereo = traffic.clip_batches(fma, {"batch_clips": 2}, SEED)[0]
    lanes = [tracks[0].data, stereo[0].data, tracks[1].data, stereo[1].data]
    with traced():
        res = decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")
    assert all(len(w) == 2 for w in res.chunk_widths)
    for got, want in zip(res.pcm, [linear[0], reference.decode(stereo[0].data),
                                   linear[1], reference.decode(stereo[1].data)]):
        _assert_compliant(got, want)
    counts = spans.totals()["counts"]
    assert counts["gomp3.corpus.mono_granules"] == tracks[0].frames + tracks[1].frames
    assert counts["gomp3.corpus.granules"] == res.granules
    assert "gomp3.corpus.reruns" not in counts


def test_corpus_matches_the_jax_package(tracks):
    """fetch=False on the LSF batch against the JAX package's
    decode_corpus_fast with the same options: equal valids, and every
    lane's PCM within ISO full accuracy of JAX's at the same length."""
    lanes = [t.data for t in tracks]
    pcm, valids = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False, device="cpu")
    jax_pcm, jax_valids = JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False)
    jax_pcm = np.asarray(jax_pcm)
    assert valids.dtype == np.int32 and np.array_equal(valids, np.asarray(jax_valids))
    assert pcm.shape == jax_pcm.shape
    for j in range(len(lanes)):
        got, want = (b"".join(p[c, j, : int(v) * 576].tobytes()
                              for c, v in enumerate(valids[:, j]))
                     for p in (pcm.numpy(), jax_pcm))
        assert len(got) == tracks[j].pcm_bytes
        _assert_compliant(got, want)


@pytest.mark.parametrize("lane", range(4))
def test_reference_span_is_the_linear_decodes_slice(tracks, linear, lane):
    """reference.pcm_span (a decode from WARM = 4 frames before the span)
    at offsets drawn across the track, the first frames and the last
    included, with 255-byte reservoirs at 143-144 bytes of main data a
    frame."""
    t = tracks[lane]
    bpf = mp3gen_lsf.BYTES_PER_FRAME_PCM
    nbytes = 4 * bpf
    rng = np.random.default_rng(lane)
    offsets = [0, bpf * 3 + 8, t.pcm_bytes - nbytes] + [
        int(x) * 4 for x in rng.integers((t.pcm_bytes - nbytes) // 4 + 1, size=5)]
    for off in offsets:
        got = reference.pcm_span(t.data, off, nbytes, t.starts, bpf)
        assert got == linear[lane][off:off + nbytes], off
