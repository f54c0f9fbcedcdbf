"""The port's decode_corpus_fast (plain chain on the CPU) against
go_mp3_tpu's decode_corpus_fast and the exact C++ backend, lane by lane,
on rotated concatenations of the repo's own bitstreams."""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu.parallel.corpus import decode_corpus_fast as jax_corpus  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast  # noqa: E402
from go_mp3_tpu_torch.reference import (  # noqa: E402
    FULL_MAXDIFF,
    FULL_RMS,
    index_stream,
    iso_metrics,
)

CONF = Path(__file__).resolve().parent.parent / "conformance"


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


@pytest.fixture(scope="module")
def lanes():
    escape = (CONF / "synthetic_escape.mp3").read_bytes() * 4
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes() * 4
    return [_rotate(escape, 1), _rotate(escape, 29),
            _rotate(lowrate, 1), _rotate(lowrate, 43)]


@pytest.fixture(scope="module")
def port_result(lanes):
    return decode_corpus_fast(lanes, chunk_t=64, device="cpu")


def _assert_compliant(a: bytes, b: bytes) -> None:
    rms, maxdiff = iso_metrics(a, b)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


def test_corpus_matches_jax_corpus(lanes, port_result):
    ref = jax_corpus(lanes, chunk_t=64)
    assert port_result.granules == ref.granules
    assert port_result.samples == ref.samples
    for got, want in zip(port_result.pcm, ref.pcm):
        _assert_compliant(got, want)


@pytest.mark.parametrize("lane", range(4))
def test_corpus_lane_matches_exact_backend(lanes, port_result, lane):
    _assert_compliant(
        port_result.pcm[lane], JaxDecoder(lanes[lane], backend="exact").read_all()
    )


def test_corpus_lane_equals_port_decoder(lanes, port_result):
    """Corpus (int8 interface, 4 lanes) and Decoder (int16 interface, one
    stream) run the same plain chain on the same granules."""
    from go_mp3_tpu_torch import Decoder

    assert port_result.pcm[2] == Decoder(lanes[2], device="cpu").read_all()


def test_corpus_phase_seconds_reported(port_result):
    assert set(port_result.phase_seconds) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    assert all(v >= 0 for v in port_result.phase_seconds.values())


def test_int8_overflow_falls_back_to_int16_interface():
    """Granules that clip the int8 tail plane take the int16 interface.
    (This stream drives the output far past full scale; the exact backend
    wraps there instead of clipping, so the reference is the JAX chain.)"""
    from util_synth import escape_heavy_frame

    data = escape_heavy_frame() * 3
    got = decode_corpus_fast([data], chunk_t=16, device="cpu")
    assert got.granules == 6
    _assert_compliant(got.pcm[0], JaxDecoder(data, backend="device").read_all())
    _assert_compliant(got.pcm[0], jax_corpus([data], chunk_t=16).pcm[0])


def test_chunk_boundaries_do_not_change_pcm(lanes, port_result):
    """Other chunk boundaries, state carried across them: the same bytes."""
    assert decode_corpus_fast(lanes, chunk_t=37, device="cpu").pcm == port_result.pcm


def test_empty_corpus():
    res = decode_corpus_fast([], device="cpu")
    assert res.pcm == [] and res.granules == 0
