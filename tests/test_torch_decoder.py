"""The port's Decoder (plain PyTorch chain on the CPU) against go_mp3_tpu's
Decoder on its JAX device backend and on the exact C++ backend, on the
repo's own bitstreams: same length, ISO full compliance, seeks, and
checkpoints; its three parse paths (C++ whole-buffer, C++ streaming,
pure Python) against each other, byte for byte; GaplessDecoder; and the
public surface against go_mp3_tpu's."""

import inspect
import io
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_mp3_tpu  # noqa: E402
import go_mp3_tpu_torch  # noqa: E402
from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu import GaplessDecoder as JaxGapless  # noqa: E402
from go_mp3_tpu_torch import Decoder, GaplessDecoder, MP3Error, NotSeekableError  # noqa: E402
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


class NonSeekable(io.RawIOBase):
    """A pipe-like reader: no seek, at most `feed` bytes per read."""

    def __init__(self, data: bytes, feed: int):
        self._b = io.BytesIO(data)
        self._feed = feed

    def read(self, n=-1):
        return self._b.read(self._feed if n is None or n < 0 else min(n, self._feed))

    def readable(self):
        return True

    def seekable(self):
        return False


def test_signature_matches_jax_decoder():
    """go_mp3_tpu.Decoder's parameters in its order and with its defaults,
    plus a keyword-only `device`."""
    port = inspect.signature(Decoder).parameters
    ref = inspect.signature(JaxDecoder).parameters
    assert list(port) == [*ref, "device"]
    for name, p in ref.items():
        assert (port[name].kind, port[name].default) == (p.kind, p.default), name
    assert port["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert port["device"].default is None


def test_backend_by_position_and_exact_backend():
    data = (CONF / "synthetic_escape.mp3").read_bytes()
    exact = JaxDecoder(data, backend="exact").read_all()
    d = Decoder(data, "device", device="cpu")
    assert d.device == torch.device("cpu")
    _assert_compliant(d.read_all(), exact)
    e = Decoder(data, backend="exact")
    assert e.device is None
    assert e.read_all() == exact
    e.seek(4608 * 3)
    ck = e.checkpoint()
    rest = e.read_all()
    e2 = Decoder(data, backend="exact")
    e2.resume(ck)
    assert e2.read_all() == rest


def test_golden_and_unknown_backends_raise():
    """The golden backend exists (tests/test_torch_conformance.py holds its
    PCM) and raises where go_mp3_tpu's does: no frame, or another
    backend's checkpoint; an unknown backend raises."""
    data = (CONF / "synthetic_escape.mp3").read_bytes()
    golden = Decoder(data, backend="golden", device="cpu")
    assert golden.device is None and golden._native is None
    with pytest.raises(MP3Error, match="no decodable frame"):
        Decoder(b"\x00" * 4096, backend="golden")
    with pytest.raises(MP3Error, match="mismatch"):
        golden.resume(Decoder(data, device="cpu").checkpoint())
    with pytest.raises(MP3Error, match="unknown"):
        Decoder(data, backend="fast", device="cpu")


def test_exports_jax_public_names():
    """Every public name of go_mp3_tpu, as the port's own object: the
    errors keep their hierarchy and lameinfo its functions."""
    for name in go_mp3_tpu.__all__:
        assert name in go_mp3_tpu_torch.__all__, name
        assert hasattr(go_mp3_tpu_torch, name), name
    for name in ("MP3Error", "NotSeekableError", "SyncSearchLimitError",
                 "UnexpectedEOFError"):
        port, ref = getattr(go_mp3_tpu_torch, name), getattr(go_mp3_tpu, name)
        assert port is not ref and port.__module__.startswith("go_mp3_tpu_torch.")
        assert issubclass(port, go_mp3_tpu_torch.MP3Error), name
        assert [c.__name__ for c in port.__mro__] == [c.__name__ for c in ref.__mro__]
    assert go_mp3_tpu_torch.lameinfo.__name__ == "go_mp3_tpu_torch.lameinfo"
    public = {n for n in vars(go_mp3_tpu.lameinfo) if not n.startswith("_")}
    assert public <= set(vars(go_mp3_tpu_torch.lameinfo))


def test_python_parse_path_equals_native(data):
    """use_native=False: the pure-Python parser and StreamDecoder (K1's
    GranuleBatch route) give the native path's bytes."""
    d = Decoder(data, use_native=False, device="cpu")
    assert d._native is None
    native = Decoder(data, device="cpu")
    assert (d.length(), d.sample_rate()) == (native.length(), native.sample_rate())
    assert d.read_all() == native.read_all()


@pytest.mark.parametrize("feed", [517, 1 << 16])
def test_streaming_source_equals_native(data, feed):
    d = Decoder(NonSeekable(data, feed), device="cpu")
    assert type(d._native).__name__ == "_StreamingNativeStream"
    assert d.length() == -1 and d.duration() == -1.0
    assert d.read_all() == Decoder(data, device="cpu").read_all()
    with pytest.raises(NotSeekableError):
        d.seek(0, io.SEEK_SET)
    with pytest.raises(NotSeekableError):
        d.seek_to_time(0.5)


def test_python_parse_path_seek(data):
    """A seek on the Python path lands where the native path's does, and
    from the target frame's second granule on, on a linear decode's bytes
    (test_decoder.py's seek contract)."""
    linear = Decoder(data, use_native=False, device="cpu").read_all()
    py = Decoder(data, use_native=False, device="cpu")
    native = Decoder(data, device="cpu")
    bpf = py.bytes_per_frame()
    target = (py.length() // bpf // 2) * bpf + 4 * 100
    reads = []
    for d in (py, native):
        d.seek(target)
        reads.append((d.tell(), d.read(2 * bpf)))
    assert reads[0] == reads[1]
    granule = 576 * 4
    skip = granule - (target % bpf) % granule
    assert reads[0][1][skip:] == linear[target + skip : target + 2 * bpf]


def test_python_path_checkpoint_crosses_packages(data):
    """A checkpoint of the Python path, taken on either package's device
    backend, resumes on the other's: same keys, same position, ISO full."""
    n = 7 * 4608 + 1234
    rests = {}
    for make_a, make_b in (
        (lambda: JaxDecoder(data, backend="device", use_native=False),
         lambda: Decoder(data, use_native=False, device="cpu")),
        (lambda: Decoder(data, use_native=False, device="cpu"),
         lambda: JaxDecoder(data, backend="device", use_native=False)),
    ):
        a = make_a()
        a.read(n)
        ck = a.checkpoint_bytes()
        rest = a.read(10 * 4608)
        b = make_b()
        b.resume_bytes(ck)
        assert set(b.checkpoint()) == set(a.checkpoint()) >= {"source_pos", "have_frame"}
        got = b.read(10 * 4608)
        assert b.tell() == a.tell()
        _assert_compliant(got, rest)
        rests[type(a).__module__] = rest
    port = Decoder(data, use_native=False, device="cpu")
    port.read(n)
    ck = port.checkpoint_bytes()
    again = Decoder(data, use_native=False, device="cpu")
    again.resume_bytes(ck)
    assert again.checkpoint_bytes() == ck
    assert again.read(10 * 4608) == rests["go_mp3_tpu_torch.decoder"]


@pytest.mark.parametrize("backend", ["device", "exact"])
def test_gapless_decoder_matches_jax(data, backend):
    kw = {"device": "cpu"} if backend == "device" else {}
    port = GaplessDecoder(data, backend=backend, **kw)
    ref = JaxGapless(data, backend=backend)
    assert isinstance(port.decoder, Decoder)
    assert port.length() == ref.length() > 0
    assert port.sample_rate() == ref.sample_rate()
    got, want = port.read_all(), ref.read_all()
    assert len(got) == port.length()
    if backend == "exact":
        assert got == want
    else:
        _assert_compliant(got, want)
    np.testing.assert_equal(port.duration(), ref.duration())
