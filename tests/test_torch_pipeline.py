"""The port's pure-Python parse path against go_mp3_tpu's, on the CPU.

granules_from_frame, pack_granule_batch, granule_batch_from_native and
parse_stream_granules are held to the JAX package's field by field,
exactly; K1's GranuleBatch route to its int16 route bit for bit;
StreamDecoder and decode_corpus to JAX's and to the exact backend within
ISO full compliance, and to the port's own other paths bit for bit. Inputs
are the repo's own: conformance/synthetic_*.mp3 and seeded synthetic frames
of every block class, stereo mode and band variant.
"""

import dataclasses
import inspect
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu.models import native_pipeline as jax_native  # noqa: E402
from go_mp3_tpu.models import pipeline as jax_pipeline  # noqa: E402
from go_mp3_tpu.parallel import corpus as jax_corpus  # noqa: E402
import go_mp3_tpu_torch.parallel as port_parallel  # noqa: E402
import torch_synthetic as syn  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast  # noqa: E402
from go_mp3_tpu_torch.models import native_pipeline as port_native  # noqa: E402
from go_mp3_tpu_torch.models import pipeline as port_pipeline  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.ops import kernels as K  # noqa: E402
from go_mp3_tpu_torch.parallel.corpus import (  # noqa: E402
    decode_corpus,
    parse_stream_granules,
)
from go_mp3_tpu_torch.reference import (  # noqa: E402
    FULL_MAXDIFF,
    FULL_RMS,
    index_stream,
    iso_metrics,
)
from test_synth_parity import CASES, random_frame  # noqa: E402
from test_torch_granule import _parsed_frame  # noqa: E402

CONF = Path(__file__).resolve().parent.parent / "conformance"
STREAMS = {
    "escape": ("synthetic_escape.mp3", 2),  # MPEG-1 44.1 kHz, mono + stereo frames
    "lowrate": ("synthetic_lowrate.mp3", 2),  # MPEG-2 22.05 kHz mono
}


def _stream(name: str) -> bytes:
    file, times = STREAMS[name]
    return (CONF / file).read_bytes() * times


def _assert_compliant(a: bytes, b: bytes) -> None:
    rms, maxdiff = iso_metrics(a, b)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


def _assert_meta_equal(port, ref) -> None:
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        for f in dataclasses.fields(j):
            a, b = getattr(p, f.name), getattr(j, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name


def _assert_batch_equal(port: P.GranuleBatch, ref) -> None:
    """A port batch [1, T, ...] == a JAX numpy batch [T, ...], field by
    field, in the dtypes K1 reads."""
    for name, (dtype, inner) in P.BATCH_FIELDS.items():
        got = getattr(port, name)
        assert got.dtype == dtype and got.device.type == "cpu", name
        assert got.is_contiguous(), name
        want = np.asarray(getattr(ref, name))
        assert tuple(got.shape) == (1, *want.shape), name
        np.testing.assert_array_equal(got[0].numpy(), want, err_msg=name)


def _synthetic_frames(seed: int):
    rng = random.Random(seed)
    return [random_frame(rng, *case) for case in CASES]


# -- staging: the same records and batches as the JAX package's ---------------


@pytest.mark.parametrize("seed", [0, 5])
def test_granules_from_frame_matches_jax(seed):
    """Every block class (the short and mixed reorders), stereo mode and
    band variant."""
    for f in _synthetic_frames(seed):
        _assert_meta_equal(port_pipeline.granules_from_frame(f),
                           jax_pipeline.granules_from_frame(f))


@pytest.mark.parametrize("pad_to", [None, 400])
def test_pack_granule_batch_matches_jax(pad_to):
    granules = [g for f in _synthetic_frames(3)
                for g in jax_pipeline.granules_from_frame(f)]
    port, n = port_pipeline.pack_granule_batch(granules, pad_to=pad_to)
    ref, n_ref = jax_pipeline.pack_granule_batch(granules, pad_to=pad_to)
    assert n == n_ref == len(granules)
    _assert_batch_equal(port, ref)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_parse_stream_granules_matches_jax(name):
    data = _stream(name)
    _assert_meta_equal(parse_stream_granules(data),
                       jax_corpus.parse_stream_granules(data))
    limited = parse_stream_granules(data, limit=7)
    _assert_meta_equal(limited, jax_corpus.parse_stream_granules(data, limit=7))
    assert 7 <= len(limited) <= 8


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("pad", [0, 9])
def test_granule_batch_from_native_matches_jax(name, pad):
    data = _stream(name)
    arrays, sr = port_native.parse_stream_native(data)
    arrays_ref, sr_ref = jax_native.parse_stream_native(data)
    assert sr == sr_ref
    for a, b in zip(arrays, arrays_ref):
        np.testing.assert_array_equal(a, b)
    n = arrays[0].shape[0]
    port, valid = port_native.granule_batch_from_native(*arrays, pad_to=n + pad)
    ref, valid_ref = jax_native.granule_batch_from_native(*arrays, pad_to=n + pad)
    assert valid == valid_ref == n
    _assert_batch_equal(port, ref)


def test_python_parse_and_native_parse_give_the_same_batch():
    """The two host parsers stage the same granules (post-reorder)."""
    data = _stream("escape")
    arrays, _ = port_native.parse_stream_native(data)
    native_batch, n = port_native.granule_batch_from_native(*arrays)
    py_batch, n_py = port_pipeline.pack_granule_batch(parse_stream_granules(data))
    assert n == n_py
    for name in P.GranuleBatch._fields:
        assert torch.equal(getattr(native_batch, name), getattr(py_batch, name)), name


def test_granule_batch_from_numpy_single_and_stacked():
    assert tuple(P.BATCH_FIELDS) == P.GranuleBatch._fields
    granules = [g for f in _synthetic_frames(4)[:20]
                for g in jax_pipeline.granules_from_frame(f)]
    one, _ = jax_pipeline.pack_granule_batch(granules[:16])
    two, _ = jax_pipeline.pack_granule_batch(granules[16:32])
    single = P.granule_batch_from_numpy(one, "cpu")
    stacked = P.granule_batch_from_numpy(
        [np.stack([a, b]) for a, b in zip(one, two)], "cpu")
    for name in P.GranuleBatch._fields:
        assert torch.equal(getattr(stacked, name)[:1], getattr(single, name)), name
        assert getattr(stacked, name).shape[:2] == (2, 16)
    bad = list(one)
    bad[2] = bad[2].reshape(16, 2, 39)  # scalefac_s flattened
    with pytest.raises(ValueError, match="scalefac_s"):
        P.granule_batch_from_numpy(bad, "cpu")


# -- K1's GranuleBatch route ------------------------------------------------


def _contiguous(b: P.GranuleBatch) -> P.GranuleBatch:
    return P.GranuleBatch(*(f.contiguous() for f in b))


@pytest.mark.parametrize("stereo", [True, False])
def test_k1_batch_route_equals_int16_route(stereo):
    """Plain versions on the CPU: the GranuleBatch route gives the int16
    route's bits on the same granules, for a batch cut from the side words
    and for one staged from frames by the Python path."""
    valid = np.array([40, 13, 0])
    sp, sd = syn.random_chunk(21, 3, 40, valid)
    packed = (torch.from_numpy(sp), torch.from_numpy(sd))
    K.reset_launch_counts()
    want = K.requant_stereo(packed, stereo)
    for a, b in zip(K.requant_stereo(_contiguous(P.batch_from_packed(*packed)), stereo), want):
        assert torch.equal(a, b)
    assert K.requant_stereo.launches == K.requant_stereo.batch_launches == 0

    rng = np.random.default_rng(8)
    frames = [syn.random_frame(rng, *case) for case in syn.CASES]
    fsp, fsd = syn.pack_frames(frames)
    granules = [g for f in frames
                for g in port_pipeline.granules_from_frame(_parsed_frame(f))]
    batch, n = port_pipeline.pack_granule_batch(granules)
    assert n == fsp.shape[0]
    want = K.requant_stereo((torch.from_numpy(fsp)[None], torch.from_numpy(fsd)[None]), stereo)
    for a, b in zip(K.requant_stereo(batch, stereo), want):
        assert torch.equal(a, b)


def test_k1_batch_route_checks_each_field():
    valid = np.array([8])
    sp, sd = syn.random_chunk(2, 1, 8, valid)
    batch = _contiguous(P.batch_from_packed(torch.from_numpy(sp), torch.from_numpy(sd)))
    with pytest.raises(TypeError, match="scalefac_s"):
        K.requant_stereo(batch._replace(scalefac_s=batch.scalefac_s.to(torch.int16)))
    with pytest.raises(TypeError, match="mono"):
        K.requant_stereo(batch._replace(mono=batch.mono.to(torch.uint8)))
    with pytest.raises(ValueError, match="variant"):
        K.requant_stereo(batch._replace(variant=batch.variant[:, :4]))
    with pytest.raises(ValueError, match="not contiguous"):
        K.requant_stereo(batch._replace(
            scalefac_l=batch.scalefac_l.transpose(2, 3).contiguous().transpose(2, 3)))


# -- StreamDecoder ------------------------------------------------------------


def _frames(name: str):
    from test_dsp_parity import parse_frames

    return parse_frames(_stream(name), nmax=10_000)


def _stream_decode(sd, frames) -> bytes:
    for f in frames:
        sd.feed_frame(f)
    return sd.decode_pending(flush=True)


@pytest.fixture(scope="module", params=sorted(STREAMS))
def stream_pcm(request):
    frames = _frames(request.param)
    pcm = _stream_decode(port_pipeline.StreamDecoder(device="cpu"), frames)
    return request.param, frames, pcm


def test_stream_decoder_compliant_vs_jax_and_exact(stream_pcm):
    name, frames, pcm = stream_pcm
    assert len(pcm) == sum(f.header.granules for f in frames) * 576 * 4
    _assert_compliant(pcm, _stream_decode(jax_pipeline.StreamDecoder(), frames))
    _assert_compliant(pcm, JaxDecoder(_stream(name), backend="exact").read_all())


@pytest.mark.parametrize("chunk_size", [4, 12])
def test_stream_decoder_chunk_invariance(stream_pcm, chunk_size):
    """A granule's PCM does not depend on where it falls in a chunk."""
    _, frames, pcm = stream_pcm
    sd = port_pipeline.StreamDecoder(chunk_size=chunk_size, device="cpu")
    assert _stream_decode(sd, frames) == pcm


def test_stream_decoder_state_resumes_from_jax_state(stream_pcm):
    """A JAX StreamDecoder's state, as numpy, carries on in the port's."""
    _, frames, pcm = stream_pcm
    half = len(frames) // 2
    jsd = jax_pipeline.StreamDecoder()
    head = _stream_decode(jsd, frames[:half])
    store, fifo = (np.asarray(a)[None] for a in jsd.state)
    sd = port_pipeline.StreamDecoder(
        state=P.state_from_numpy(store, fifo, "cpu"), device="cpu")
    _assert_compliant(head + _stream_decode(sd, frames[half:]), pcm)
    sd.reset()
    assert _stream_decode(sd, frames) == pcm


def test_stream_decoder_signature():
    assert list(inspect.signature(port_pipeline.StreamDecoder).parameters) == [
        "chunk_size", "state", "_pending", "device"]
    from go_mp3_tpu import models as jax_models
    from go_mp3_tpu_torch import models as port_models

    assert port_models.__all__ == jax_models.__all__


# -- decode_corpus -----------------------------------------------------------


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


@pytest.fixture(scope="module")
def corpus():
    """Ragged lanes: 72, 48, 52 and 26 granules."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes()
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes()
    lanes = [_rotate(escape * 3, 9), _rotate(escape * 2, 5),
             _rotate(lowrate * 2, 3), lowrate]
    streams = [parse_stream_granules(d) for d in lanes]
    return lanes, streams, decode_corpus(streams, chunk_t=32, device="cpu")


def test_decode_corpus_matches_jax_and_exact(corpus):
    lanes, streams, res = corpus
    assert [len(s) for s in streams] == [72, 48, 52, 26]
    ref = jax_corpus.decode_corpus(streams, chunk_t=32)
    assert (res.granules, res.samples) == (ref.granules, ref.samples)
    for got, want, data in zip(res.pcm, ref.pcm, lanes):
        _assert_compliant(got, want)
        _assert_compliant(got, JaxDecoder(data, backend="exact").read_all())


def test_decode_corpus_equals_decode_corpus_fast_unfused(corpus):
    """Python parse + GranuleBatch route == C++ parse + int8 interface, bit
    for bit, on the same lanes and chunk length."""
    lanes, _, res = corpus
    fast = decode_corpus_fast(lanes, chunk_t=32, fused=False, device="cpu")
    assert res.pcm == fast.pcm and res.granules == fast.granules


def test_decode_corpus_decode_fn_and_phases(corpus):
    """decode_fn keeps JAX's contract (batch, states, valid) -> (pcm,
    states); the default is kernels.decode_chunk, on the GranuleBatch."""
    _, streams, res = corpus
    seen = []

    def decode_fn(batch, states, valid):
        seen.append((type(batch), tuple(batch.spectra.shape), valid.tolist()))
        return K.decode_chunk(batch, states, valid)

    got = decode_corpus(streams, chunk_t=32, decode_fn=decode_fn, device="cpu")
    assert got.pcm == res.pcm
    assert seen[0][:2] == (P.GranuleBatch, (4, 32, 2, 576))
    assert [v for *_, v in seen] == [[32, 32, 32, 26], [32, 16, 20, 0], [8, 0, 0, 0]]
    assert set(res.phase_seconds) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    assert res.phase_seconds["pack"] > 0 and res.phase_seconds["parse"] == 0


def test_decode_corpus_chunk_length_does_not_change_pcm(corpus):
    _, streams, res = corpus
    assert decode_corpus(streams, chunk_t=7, device="cpu").pcm == res.pcm


def test_decode_corpus_empty_and_exports():
    res = decode_corpus([], device="cpu")
    assert res.pcm == [] and res.granules == 0
    from go_mp3_tpu import parallel as jax_parallel

    for name in ("CorpusResult", "decode_corpus", "decode_corpus_fast",
                 "parse_stream_granules"):
        assert name in jax_parallel.__all__ and name in port_parallel.__all__
    port_sig = inspect.signature(decode_corpus)
    jax_sig = inspect.signature(jax_corpus.decode_corpus)
    assert list(port_sig.parameters) == [*jax_sig.parameters, "device"]
    for name, p in jax_sig.parameters.items():
        assert port_sig.parameters[name].default == p.default
