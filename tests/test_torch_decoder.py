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
from go_mp3_tpu_torch.ops.kernels import decode_chunk  # noqa: E402
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
def test_streaming_source_equals_native(data, feed, traced, monkeypatch):
    """A non-seekable source reads the native path's bytes; each device
    call, however few granules a feed let the parser return, ships them
    in as many rows rounded up to 4."""
    want = Decoder(data, device="cpu").read_all()
    calls = []  # (granules, rows) of each device call, as the chain gets them

    def chain(packed, state, valid, out):
        calls.append((int(valid[0]), packed[0].shape[1]))
        return decode_chunk(packed, state, valid, out)

    monkeypatch.setattr(go_mp3_tpu_torch.decoder, "decode_chunk", chain)
    with traced():
        d = Decoder(NonSeekable(data, feed), device="cpu")
        pcm = d.read_all()
    assert type(d._native).__name__ == "_StreamingNativeStream"
    assert d.length() == -1 and d.duration() == -1.0
    assert pcm == want
    counts = go_mp3_tpu_torch.spans.totals()["counts"]
    rows = [-(-n // 4) * 4 for n, _ in calls]
    assert [r for _, r in calls] == rows
    assert counts["gomp3.decoder.rows"] == sum(rows)
    assert counts["gomp3.decoder.granules"] == sum(n for n, _ in calls) == len(pcm) // GRANULE
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


# -- the post-seek decode: the warm-up and the first read in one device call

GRANULE = 576 * 4  # PCM bytes a granule
CARD = ("gomp3.decoder.h2d", "gomp3.decoder.launch", "gomp3.decoder.d2h")


def _player_track() -> bytes:
    """A track as the benchmark's gomp3_player (MPEG-1, 128 kbps joint
    stereo), 6 s."""
    import json

    from benchmark.gen import traffic

    root = CONF.parent
    cfg = json.loads((root / "benchmark/configs/gomp3_player.json").read_text())
    cfg.update(tracks=1, track_seconds=6, pool={"runs_per_bitrate": 2, "frames_per_run": 8})
    return traffic.tracks(cfg, 2 ** 31 + 3)[0].data


@pytest.fixture(scope="module", params=["mpeg1_128k", "mpeg2_lowrate"])
def seekable(request):
    """(stream, its linear decode): an MPEG-1 track of 230 frames and an
    MPEG-2 mono stream of 208 frames (one granule a frame)."""
    if request.param == "mpeg1_128k":
        data = _player_track()
    else:
        data = (CONF / "synthetic_lowrate.mp3").read_bytes() * 8
    return data, Decoder(data, device="cpu").read_all()


@pytest.fixture
def traced():
    """A CPU profiler's window, with the port's span totals cleared."""
    from torch.profiler import ProfilerActivity, profile

    go_mp3_tpu_torch.spans.reset()
    yield lambda: profile(activities=[ProfilerActivity.CPU])
    go_mp3_tpu_torch.spans.reset()


def _seek_plan(d: Decoder, pos: int) -> tuple[int, int, int]:
    """(target frame, warm-up depth, PCM bytes the seek drops)."""
    bpf = d.bytes_per_frame()
    f = pos // bpf
    k = d._warmup_depth(f)
    return f, k, k * bpf + pos % bpf


def _positions(d: Decoder) -> dict:
    bpf = d.bytes_per_frame()
    return {
        "frame0": 4 * 17,  # k = 0
        "frame1": bpf + 4 * 301,  # k = 1
        "middle": (d.length() // bpf // 2) * bpf + 4 * 123,
        "past_end": d.length() - 3000,  # the read runs past the stream's end
    }


@pytest.mark.parametrize("where", ["frame0", "frame1", "middle", "past_end"])
def test_seek_then_read_is_one_device_call(seekable, traced, where):
    """seek + read(32768): the linear decode's bytes, from one device call
    that decodes the warm-up frames and whole frames after them until the
    dropped bytes and the read are covered, in as many rows as granules
    rounded up to 4; one fold counted."""
    data, linear = seekable
    d = Decoder(data, device="cpu")
    pos = _positions(d)[where]
    f, k, drop = _seek_plan(d, pos)
    if where.startswith("frame"):
        assert k == int(where[-1])  # the warm-up starts at frame 0
    with traced():
        d.seek(pos)
        got = d.read(32768)
    assert got == linear[pos:pos + 32768] and d.tell() == pos + len(got)
    tot = go_mp3_tpu_torch.spans.totals()
    assert {n: tot["spans"][n]["n"] for n in CARD} == dict.fromkeys(CARD, 1)
    counts = tot["counts"]
    assert counts["gomp3.decoder.seek_folds"] == 1
    assert counts["gomp3.decoder.warmup_frames"] == k
    granules, rows = counts["gomp3.decoder.granules"], counts["gomp3.decoder.rows"]
    gpf = d.bytes_per_frame() // GRANULE
    frames_left = len(linear) // d.bytes_per_frame() - (f - k)
    want_frames = -(-(drop + 32768) // (gpf * GRANULE))  # whole frames that cover them
    assert granules == gpf * min(want_frames, frames_left)
    assert rows == -(-granules // 4) * 4 <= 128


def test_seek_then_read_all(seekable, traced):
    """read(-1) after a seek: the first decode folds the warm-up into a
    decode as long as the readahead (the read's shortfall passes CHUNK
    rows), every later decode is the readahead; each ships its granules
    in as many rows rounded up to 4."""
    data, linear = seekable
    d = Decoder(data, device="cpu")
    bpf = d.bytes_per_frame()
    pos = (d.length() // bpf // 3) * bpf + 4 * 55
    f, k, _ = _seek_plan(d, pos)
    with traced():
        d.seek(pos)
        got = d.read(-1)
    assert got == linear[pos:]
    gpf = bpf // GRANULE
    per_decode = 64 if gpf == 2 else 127  # frames a decode of 128 rows parses
    full, last = divmod(len(linear) // bpf - (f - k), per_decode)
    granules = [per_decode * gpf] * full + [last * gpf] * (last > 0)
    tot = go_mp3_tpu_torch.spans.totals()
    assert {n: tot["spans"][n]["n"] for n in CARD} == dict.fromkeys(CARD, len(granules))
    assert tot["counts"]["gomp3.decoder.seek_folds"] == 1
    assert tot["counts"]["gomp3.decoder.granules"] == sum(granules)
    assert tot["counts"]["gomp3.decoder.rows"] == sum(-(-g // 4) * 4 for g in granules)


def test_seek_seek_read(seekable, traced):
    """A second seek drops the first one's pending rows: one device call,
    at the second target."""
    data, linear = seekable
    d = Decoder(data, device="cpu")
    bpf = d.bytes_per_frame()
    first, second = 3 * bpf + 8, (d.length() // bpf - 40) * bpf + 4 * 7
    with traced():
        d.seek(first)
        d.seek(second)
        got = d.read(20000)
    assert got == linear[second:second + 20000]
    tot = go_mp3_tpu_torch.spans.totals()
    assert {n: tot["spans"][n]["n"] for n in CARD} == dict.fromkeys(CARD, 1)
    assert tot["counts"]["gomp3.decoder.seek_folds"] == 1
    assert tot["counts"]["gomp3.decoder.warmup_frames"] == (
        _seek_plan(d, first)[1] + _seek_plan(d, second)[1])


BACKENDS = {"device": {"device": "cpu"}, "exact": {"backend": "exact"}}


def _linear(seekable, backend: str) -> bytes:
    data, linear = seekable
    return linear if backend == "device" else Decoder(data, backend="exact").read_all()


def _decoded_once(data: bytes, backend: str, frame: int, n_frames: int) -> tuple:
    """(PCM, native stream) of a fresh native stream that pends n_frames
    frames from `frame` with nothing to drop and decodes them once."""
    eager = Decoder(data, **BACKENDS[backend])._native
    starts, bpf, _ = eager.index()
    eager.restart(int(starts[frame]))
    eager.reset_state()
    eager.pend_frames(n_frames, int(bpf), 0)
    return eager.decode_more(), eager


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("where", ["frame1", "middle"])
def test_checkpoint_after_seek_is_the_eager_one(seekable, where, backend):
    """checkpoint() right after a seek decodes the pending warm-up: the
    buffer of a decode of the k + 1 warm-up frames at the seek (the linear
    decode's bytes, and on the device backend the pure-Python path's,
    which decodes them at the seek), and the parser offset, reservoir and
    DSP state of a stream that decoded those frames once; resumed on a
    fresh Decoder, the read is the linear decode's."""
    data, _ = seekable
    linear = _linear(seekable, backend)
    d = Decoder(data, **BACKENDS[backend])
    pos = _positions(d)[where]
    f, k, drop = _seek_plan(d, pos)
    d.seek(pos)
    ck = d.checkpoint_bytes()

    got = go_mp3_tpu_torch.utils.state.checkpoint_from_bytes(ck)
    pcm, eager = _decoded_once(data, backend, f - k, k + 1)
    assert got["buf"] == pcm[drop:] == linear[pos:(f + 1) * d.bytes_per_frame()]
    if backend == "device":
        py = Decoder(data, use_native=False, device="cpu")
        py.seek(pos)
        assert got["buf"] == py.checkpoint()["buf"]
    assert got["parser_offset"] == eager._parser.tell()
    assert got["reservoir"] == eager._parser.get_reservoir()
    for a, b in zip(got["dsp"][1:], eager._staging.state()[1:]):
        np.testing.assert_array_equal(a, b)

    assert d.read(32768) == linear[pos:pos + 32768]
    fresh = Decoder(data, **BACKENDS[backend])
    fresh.resume_bytes(ck)
    assert fresh.checkpoint_bytes() == ck
    assert fresh.read(32768) == linear[pos:pos + 32768]


def _corrupt_big_values(data: bytes, frame_start: int) -> bytes:
    """The frame at frame_start with its first granule-channel's
    part2_3_length 1 and big_values 511: the C++ parser's "is_pos too big",
    a hard error; the frame index is unchanged."""
    b1, b3 = data[frame_start + 1], data[frame_start + 3]
    mpeg1, mono, crc = b1 & 0x08, b3 >> 6 == 3, not b1 & 1
    at = 8 * (frame_start + 4 + 2 * crc)  # the side info's first bit
    at += (9 + (5 if mono else 3) + (4 if mono else 8)) if mpeg1 else (8 + (1 if mono else 2))
    bits = list("".join(f"{x:08b}" for x in data))
    bits[at:at + 21] = f"{1:012b}" + f"{511:09b}"
    return bytes(int("".join(bits[i:i + 8]), 2) for i in range(0, len(bits), 8))


def _broken_at(seekable, bad: str):
    """(stream with a hard error in one frame of a seek's warm-up, the
    seek's byte offset, target frame, warm-up depth, bytes dropped)."""
    data, _ = seekable
    d = Decoder(data, device="cpu")
    bpf = d.bytes_per_frame()
    pos = (d.length() // bpf - 30) * bpf + 4 * 9  # past the open's readahead
    f, k, drop = _seek_plan(d, pos)
    assert k >= 2
    starts = d._native.index()[0]
    broken = _corrupt_big_values(data, int(starts[f - k if bad == "first" else f]))
    assert Decoder(broken, device="cpu").length() == d.length()
    return broken, pos, f, k, drop


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_corrupt_warmup_frame_raises_from_seek(seekable, backend):
    """A hard parse error in the first frame the seek parses raises from
    seek, as go-mp3's Seek returns its frames' errors."""
    broken, pos, *_ = _broken_at(seekable, "first")
    b = Decoder(broken, **BACKENDS[backend])
    with pytest.raises(ValueError, match="native parse failed"):
        b.seek(pos)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_corrupt_target_frame_still_cuts_the_warmup(seekable, backend):
    """A hard error in the target frame stops the seek's C++ parse short
    (the parser skips that frame); the read parses on from there, and the
    dropped bytes are cut in full from the PCM that follows, though the
    warm-up's own PCM is shorter than they are."""
    broken, pos, f, k, drop = _broken_at(seekable, "target")
    b = Decoder(broken, **BACKENDS[backend])
    b.seek(pos)
    got = b.read(32768)
    pcm, eager = _decoded_once(broken, backend, f - k, k + 1)
    pcm += eager.decode_more()  # the readahead after them
    assert got == pcm[drop:drop + 32768] and len(got) == 32768


# -- the native stream's staging: host rows, device buffers and the zero state
# reused by every device call


def _staging_tensors(d: Decoder) -> list:
    st = d._native._staging
    return [v for v in vars(st).values() if isinstance(v, torch.Tensor)]


def _dirty(d: Decoder) -> None:
    """Every buffer of the stream's staging, host and device, filled with
    0x5A bytes."""
    for t in _staging_tensors(d):
        t.view(torch.uint8).fill_(0x5A)


def test_parser_writes_every_word_of_a_granule(seekable):
    """The C++ packed parse writes every line and side word of each granule
    it returns, whatever the rows held: a stream parsed into 0x5A rows
    equals the same parse into zero rows, chunk by chunk (reused rows rest
    on this)."""
    from go_mp3_tpu_torch.consts import SIDE_WIDTH
    from go_mp3_tpu_torch.native import lib as native

    data, _ = seekable
    clean, dirty = native.NativeParser(data), native.NativeParser(data)
    chunks = 0
    while True:
        rows = [(np.zeros((128, 1152), np.int16), np.zeros((128, SIDE_WIDTH), np.int16)),
                (np.full((128, 1152), 0x5A5A, np.int16),
                 np.full((128, SIDE_WIDTH), 0x5A5A, np.int16))]
        n = clean.parse_packed_into(*rows[0])
        assert dirty.parse_packed_into(*rows[1]) == n
        if n == 0:
            break
        np.testing.assert_array_equal(rows[1][0][:n], rows[0][0][:n])
        np.testing.assert_array_equal(rows[1][1][:n], rows[0][1][:n])
        chunks += 1
    assert chunks >= 2


def test_dirty_staging_gives_the_linear_bytes(seekable):
    """A stream's staging filled with garbage before each seek: every seek
    and read gives a fresh Decoder's bytes and the linear decode's, the
    folded seek call and the 128-row readahead both."""
    data, linear = seekable
    d = Decoder(data, device="cpu")
    bpf = d.bytes_per_frame()
    for pos in (_positions(d)["middle"], bpf + 4 * 301, (d.length() // bpf - 40) * bpf + 8):
        _dirty(d)
        d.seek(pos)
        got = d.read(32768)
        fresh = Decoder(data, device="cpu")
        fresh.seek(pos)
        assert got == fresh.read(32768) == linear[pos:pos + 32768]
    _dirty(d)
    pos = (d.length() // bpf // 4) * bpf + 4 * 55
    d.seek(pos)
    d.read(32768)
    _dirty(d)  # the readahead's rows too
    assert d.read(-1) == linear[pos + 32768:]


def test_staging_and_zero_state_are_reused(seekable):
    """50 seeks and reads ship through the buffers the stream made at its
    open, and every seek points the state at the device's one zero state,
    which stays zero."""
    from go_mp3_tpu_torch.decoder import _zero_state

    data, linear = seekable
    d = Decoder(data, device="cpu")
    ptrs = [t.data_ptr() for t in _staging_tensors(d)]
    zero = _zero_state(torch.device("cpu"))
    rng = np.random.default_rng(17)
    for pos in rng.integers(0, d.length() - 4, 50):
        pos = int(pos) & ~3
        d.seek(pos)
        assert d._native._staging._state is zero
        assert d.read(8192) == linear[pos:pos + 8192]
    assert [t.data_ptr() for t in _staging_tensors(d)] == ptrs
    assert not zero.store.any() and not zero.v_fifo.any()


def test_checkpoint_and_resume_do_not_alias_the_zero_state(seekable):
    """A checkpoint taken at the zero state (a seek past the end) holds its
    own arrays, and a resume builds its own state: writing either leaves
    the shared zero state zero, and the bytes after a resume are the
    linear decode's."""
    from go_mp3_tpu_torch.decoder import _zero_state

    data, linear = seekable
    zero = _zero_state(torch.device("cpu"))
    d = Decoder(data, device="cpu")
    d.seek(d.length() + 100)
    ck = d.checkpoint()
    for a in ck["dsp"][1:]:
        a += 1.0
    assert not zero.store.any() and not zero.v_fifo.any()

    pos = _positions(d)["middle"]
    d.seek(pos)
    ck = d.checkpoint()
    fresh = Decoder(data, device="cpu")
    fresh.resume(ck)
    assert fresh._native._staging._state.store is not zero.store
    assert fresh.read(32768) == d.read(32768) == linear[pos:pos + 32768]
    fresh.resume(ck)
    assert fresh.read(32768) == linear[pos:pos + 32768]
    assert not zero.store.any() and not zero.v_fifo.any()
