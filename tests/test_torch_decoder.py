"""The port's Decoder (plain PyTorch chain on the CPU) against go_mp3_tpu's
Decoder on its JAX device backend and on the exact C++ backend, on the
repo's own bitstreams: same length, ISO full compliance, seeks, and
checkpoints."""

import io
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu.consts import MP3Error  # noqa: E402
from go_mp3_tpu_torch import Decoder  # noqa: E402
from go_mp3_tpu_torch import reference  # noqa: E402
from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, iso_metrics  # noqa: E402

CONF = Path(__file__).resolve().parent.parent / "conformance"
INPUTS = {
    "escape": ("synthetic_escape.mp3", 1),
    "lowrate": ("synthetic_lowrate.mp3", 1),
    "escape_x4": ("synthetic_escape.mp3", 4),
    "lowrate_x4": ("synthetic_lowrate.mp3", 4),
}


@pytest.fixture(scope="module", params=sorted(INPUTS))
def data(request):
    name, times = INPUTS[request.param]
    return (CONF / name).read_bytes() * times


def _assert_compliant(a: bytes, b: bytes) -> None:
    rms, maxdiff = iso_metrics(a, b)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


def test_length_and_full_decode_compliant(data):
    port = Decoder(data, device="cpu")
    jax_dev = JaxDecoder(data, backend="device")
    exact = JaxDecoder(data, backend="exact")
    assert port.length() == jax_dev.length() == exact.length() > 0
    assert port.sample_rate() == exact.sample_rate()
    pcm = port.read_all()
    assert len(pcm) == port.length()
    _assert_compliant(pcm, jax_dev.read_all())
    _assert_compliant(pcm, exact.read_all())


def test_reference_module_is_the_exact_backend(data):
    """go_mp3_tpu_torch.reference (what chip_smoke.py compares against)
    gives the exact backend's bytes and the stream's own index."""
    exact = JaxDecoder(data, backend="exact")
    assert reference.native_available()
    assert reference.decode_exact(data) == exact.read_all()
    starts, _, rate = reference.index_stream(data)
    samples_per_frame = 1152 if rate >= 32000 else 576  # MPEG-1 / MPEG-2
    assert rate == exact.sample_rate()
    assert len(starts) * samples_per_frame * 4 == exact.length()


def test_seek_then_read_compliant(data):
    port = Decoder(io.BytesIO(data), device="cpu")
    t = port.duration() * 0.4
    reads = []
    for d in (port, JaxDecoder(data, backend="device"), JaxDecoder(data, backend="exact")):
        d.seek_to_time(t)
        reads.append((d.tell(), d.read(40000)))
    assert reads[0][0] == reads[1][0] == reads[2][0]
    assert len(reads[0][1]) > 0
    _assert_compliant(reads[0][1], reads[1][1])
    _assert_compliant(reads[0][1], reads[2][1])


def test_checkpoint_bytes_round_trip(data):
    a = Decoder(data, device="cpu")
    a.read(30000)
    ck = a.checkpoint_bytes()
    rest = a.read_all()
    b = Decoder(data, device="cpu")
    b.resume_bytes(ck)
    assert b.checkpoint_bytes() == ck
    assert b.read_all() == rest


def test_checkpoint_resumes_on_jax_device_backend(data):
    """Both packages' device backends share the checkpoint format."""
    a = Decoder(data, device="cpu")
    a.read(30000)
    ck = a.checkpoint_bytes()
    rest = a.read_all()
    j = JaxDecoder(data, backend="device")
    j.resume_bytes(ck)
    _assert_compliant(rest, j.read_all())


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is valid here")
    data = (CONF / "synthetic_escape.mp3").read_bytes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(data)


def test_unparseable_source_raises():
    with pytest.raises(MP3Error):
        Decoder(b"\x00" * 4096, device="cpu")
