"""A low-rate catalogue through the port's corpus path, on the CPU.

The benchmark's low-rate writer (benchmark/gen/mp3gen_rates.py) makes a
small seeded batch of the three rungs of fma_lowrate: 128 kbps MPEG-1 at
44.1 kHz (mp3gen's), 96 kbps MPEG-1 at 32 kHz and 64 kbps MPEG-2 LSF joint
stereo at 24 kHz, two lanes of each, of unequal length in granules. The
port's C++ and pure-Python parsers read the two new formats alike and as
written; decode_corpus_fast decodes the mixed call within ISO/IEC 11172-4
full accuracy of the benchmark's plain reference, each lane as it decodes
alone, and as the JAX package's decode_corpus_fast; and the counter
gomp3.corpus.slots counts every lane's rows of every chunk shipped, valid
or not, on the fused and the unfused path."""

import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import go_mp3_tpu.parallel.corpus as JC  # noqa: E402
from benchmark.gen import mp3gen_rates  # noqa: E402
from benchmark.reference import decode as reference  # noqa: E402
from go_mp3_tpu.bitstream import Source as JaxSource  # noqa: E402
from go_mp3_tpu.bitstream.parser import FrameReader as JaxFrameReader  # noqa: E402
from go_mp3_tpu.consts import EOFError_ as JaxEOFError  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast, spans  # noqa: E402
from go_mp3_tpu_torch.bitstream import Source  # noqa: E402
from go_mp3_tpu_torch.bitstream.frameheader import Mode  # noqa: E402
from go_mp3_tpu_torch.bitstream.parser import FrameReader  # noqa: E402
from go_mp3_tpu_torch.consts import EOFError_  # noqa: E402
from go_mp3_tpu_torch.models import native_pipeline  # noqa: E402
from go_mp3_tpu_torch.models.pipeline import pack_granule_batch  # noqa: E402
from go_mp3_tpu_torch.ops.granule import GranuleBatch  # noqa: E402
from go_mp3_tpu_torch.parallel.corpus import parse_stream_granules  # noqa: E402
from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, iso_metrics  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SEED = 2 ** 31 + 13
CHUNK_T = 32
NEW = {"mpeg1_32k": (mp3gen_rates.MPEG1_32K, 96), "mpeg2_24k": (mp3gen_rates.MPEG2_24K, 64)}


def _cfg(**sizes) -> dict:
    cfg = json.loads((ROOT / "benchmark/configs/fma_lowrate.json").read_text())
    cfg.update(pool={"runs_per_bitrate": 2, "frames_per_run": 16}, **sizes)
    return cfg


@pytest.fixture(scope="module")
def clips():
    """Two clips of each rung, 3 s at each rung's rate: 230, 168 and 125
    granules, in an order drawn from the seed."""
    cfg = _cfg(catalogue_clips=6, clip_seconds=3)
    return mp3gen_rates.clip_batches(cfg, {"batch_clips": 6}, SEED)[0]


@pytest.fixture(scope="module")
def linear(clips):
    return [reference.decode(c.data) for c in clips]


@pytest.fixture(scope="module", params=sorted(NEW))
def run_fields(request):
    """One writer run of a new format, its fields kept, short and mixed
    blocks (MPEG-1 only) more often than the configuration's."""
    fmt, br = NEW[request.param]
    cfg = _cfg()
    out = mp3gen_rates.make_run_fields(
        np.random.default_rng(SEED), fmt, br, 48, run_frames=24,
        lowpass_hz=cfg["lowpass_hz"][str(br)], short_share=0.25,
        mixed_share=0.0 if fmt.lsf else 0.08, ms_share=cfg["ms_share"],
        loudness_rms=cfg["loudness_rms"])
    return fmt, br, out


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


def _lane_pcm(pcm, valids, j: int) -> bytes:
    return b"".join(pcm[c, j, : int(v) * 576].tobytes() for c, v in enumerate(valids[:, j]))


def test_clips_are_of_three_formats_and_unequal_length(clips):
    got = sorted((c.bitrate, c.sample_rate, c.granules) for c in clips)
    assert got == [(64, 24000, 125)] * 2 + [(96, 32000, 168)] * 2 + [(128, 44100, 230)] * 2


def test_python_parser_reads_what_was_written(run_fields):
    fmt, br, (data, starts, gcs, ms) = run_fields
    frames = _read_frames(data)
    ngr = fmt.granules
    assert len(frames) == 48 and len(gcs) == 48 * 2 * ngr
    kinds = {g["kind"] for g in gcs}
    assert kinds >= {mp3gen_rates.LONG, mp3gen_rates.START, mp3gen_rates.SHORT,
                     mp3gen_rates.STOP}
    assert (mp3gen_rates.MIXED in kinds) == (not fmt.lsf)
    for f, frame in enumerate(frames):
        h, si, md = frame.header, frame.side_info, frame.main_data
        assert (h.low_sampling_frequency, h.sampling_frequency_value(), h.number_of_channels,
                h.granules, h.bitrate, h.mode) == (
            fmt.lsf, fmt.sample_rate, 2, ngr, br * 1000, Mode.JOINT_STEREO)
        assert h.use_ms_stereo == bool(ms[f]) and not h.use_intensity_stereo
        assert frame.start_position == starts[f]
        for gr in range(ngr):
            for ch in range(2):
                g = gcs[2 * ngr * f + 2 * gr + ch]
                assert (si.part2_3_length[gr][ch], si.big_values[gr][ch],
                        si.global_gain[gr][ch], si.scalefac_compress[gr][ch],
                        si.preflag[gr][ch]) == (g["part23"], g["big_values"], g["gg"],
                                                g["sfc"], g["preflag"])
                np.testing.assert_array_equal(md.is_[gr][ch], g["q"])
                if g["kind"] == mp3gen_rates.SHORT:
                    np.testing.assert_array_equal(md.scalefac_s[gr][ch][:12], g["sf_s"][:12])
                elif g["kind"] != mp3gen_rates.MIXED:
                    np.testing.assert_array_equal(md.scalefac_l[gr][ch][:21], g["sf_l"][:21])


def test_cpp_and_python_parsers_read_the_clips_alike(clips):
    for c in clips:
        arrays, rate = native_pipeline.parse_stream_native(c.data)
        assert rate == c.sample_rate
        native, n = native_pipeline.granule_batch_from_native(*arrays)
        python, n_py = pack_granule_batch(parse_stream_granules(c.data))
        assert n == n_py == c.granules
        for name in GranuleBatch._fields:
            assert torch.equal(getattr(native, name), getattr(python, name)), name


def test_jax_parser_reads_the_frames_as_the_port(run_fields):
    """The JAX package's parser against the port's pure-Python one on a
    run of each new format: header, side info, scalefactors and Huffman
    values field by field, at the same frame positions."""
    data = run_fields[2][0]
    port = _read_frames(data)
    jax = _read_frames(data, JaxSource, JaxFrameReader, JaxEOFError)
    assert len(port) == len(jax) == 48
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


@pytest.fixture(scope="module")
def mixed(clips):
    """decode_corpus_fast(fetch=False) on the mixed batch, with its
    defaults but the chunk size."""
    pcm, valids = decode_corpus_fast([c.data for c in clips], chunk_t=CHUNK_T, fetch=False,
                                     device="cpu")
    return pcm.numpy(), valids


def test_mixed_call_within_iso_limits(clips, linear, mixed):
    pcm, valids = mixed
    assert valids.dtype == np.int32
    assert list(valids.sum(0)) == [c.granules for c in clips]
    # MPEG-1 lanes ship up to CHUNK_T granules a chunk, LSF lanes CHUNK_T - 1
    assert valids.shape[0] == max(-(-c.granules // (CHUNK_T - (c.sample_rate == 24000)))
                                  for c in clips)
    for j, (c, want) in enumerate(zip(clips, linear)):
        got = _lane_pcm(pcm, valids, j)
        assert len(got) == c.pcm_bytes
        _assert_compliant(got, want)


def test_each_lane_decodes_as_it_does_alone(clips, mixed):
    """A lane's PCM in the mixed call is the PCM of the lane decoded alone,
    byte for byte: lanes of other formats, and lanes that have ended, do
    not touch it."""
    pcm, valids = mixed
    for j, c in enumerate(clips):
        alone = decode_corpus_fast([c.data], chunk_t=CHUNK_T, device="cpu").pcm[0]
        assert _lane_pcm(pcm, valids, j) == alone, j


def test_mixed_call_matches_the_jax_package(clips, mixed):
    """The JAX package's decode_corpus_fast with the same options: equal
    valids, and every lane's PCM within ISO full accuracy of JAX's."""
    pcm, valids = mixed
    jax_pcm, jax_valids = JC.decode_corpus_fast([c.data for c in clips], chunk_t=CHUNK_T,
                                                fetch=False)
    jax_pcm = np.asarray(jax_pcm)
    assert np.array_equal(valids, np.asarray(jax_valids))
    assert pcm.shape == jax_pcm.shape
    for j in range(len(clips)):
        _assert_compliant(_lane_pcm(pcm, valids, j), _lane_pcm(jax_pcm, valids, j))


@pytest.mark.parametrize("opts", [{"fetch": False}, {"fetch": False, "fused": False},
                                  {"drain": 3}],
                         ids=["fused", "unfused", "drain3"])
def test_slots_count_every_lanes_rows(clips, opts):
    """gomp3.corpus.slots: chunks x lanes x chunk_t (with drain=k, every
    segment's k chunks, a short last one's padding included);
    gomp3.corpus.granules: the valid ones."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        res = decode_corpus_fast([c.data for c in clips], chunk_t=CHUNK_T, device="cpu", **opts)
    counts = spans.totals()["counts"]
    spans.reset()
    granules = sum(c.granules for c in clips)
    if opts.get("fetch", True):
        chunks = len(res.chunk_widths)
        assert res.granules == granules
        chunks = -(-chunks // opts["drain"]) * opts["drain"]
    else:
        chunks = len(res[1])
        assert int(res[1].sum()) == granules
    assert counts["gomp3.corpus.slots"] == chunks * len(clips) * CHUNK_T
    assert counts["gomp3.corpus.granules"] == granules
    assert "gomp3.corpus.reruns" not in counts


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_reference_span_is_the_linear_decodes_slice(clips, linear, lane):
    """reference.pcm_span at a granule-counted span of four granules, at
    offsets across the clip (the first and the last included), decoded at
    the clip's own frame: the linear decode's slice, on each format."""
    fmts = sorted({c.sample_rate for c in clips})
    j = next(i for i, c in enumerate(clips) if c.sample_rate == fmts[lane])
    c = clips[j]
    nbytes = 4 * mp3gen_rates.BYTES_PER_GRANULE_PCM
    rng = np.random.default_rng(lane)
    offsets = [0, c.frame_pcm_bytes * 3 + 8, c.pcm_bytes - nbytes] + [
        int(x) * 4 for x in rng.integers((c.pcm_bytes - nbytes) // 4 + 1, size=4)]
    for off in offsets:
        got = reference.pcm_span(c.data, off, nbytes, c.starts, c.frame_pcm_bytes)
        assert got == linear[j][off:off + nbytes], off
