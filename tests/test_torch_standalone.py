"""The port's own copies of the host layers against the JAX package's
originals, bit for bit: the bitstream parse (header by header, field by
field), the C++ parser (every interface, the stream index, the fused-tail
pack), Decoder(backend="exact") and backend="golden" PCM, lameinfo, and
checkpoint_bytes. Each case runs on the repo's bitstreams and on streams
built in code (tests/util_synth.py, test_lameinfo.build_xing_frame)."""

import dataclasses
import enum
import importlib
import io
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import util_synth as us  # noqa: E402
from test_lameinfo import build_xing_frame  # noqa: E402

import go_mp3_tpu  # noqa: E402
import go_mp3_tpu_torch  # noqa: E402
from go_mp3_tpu import bitstream as jax_bitstream  # noqa: E402
from go_mp3_tpu import consts as jax_consts  # noqa: E402
from go_mp3_tpu import lameinfo as jax_lameinfo  # noqa: E402
from go_mp3_tpu.native import lib as jax_native  # noqa: E402
from go_mp3_tpu_torch import bitstream, consts, lameinfo  # noqa: E402
from go_mp3_tpu_torch.native import lib as native  # noqa: E402

CONF = Path(__file__).resolve().parent.parent / "conformance"


def _streams() -> dict:
    escape = (CONF / "synthetic_escape.mp3").read_bytes()
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes()
    silent = us.silent_frame()
    return {
        "escape": escape,
        "lowrate": lowrate,
        # tags before and after, and junk before the first frame
        "escape_tagged": (us.id3v2_tag(300) + b"\x00junk" + escape * 2
                          + us.apev2_tag(2) + us.id3v1_tag()),
        # main_data_begin spanning all earlier frames' main data
        "mpeg2_reservoir": us.low_bitrate_mpeg2_stream()[0],
        # escape-coded lines of |x| > 127 (the int16 head plane)
        "escape_heavy": us.escape_heavy_frame() * 6,
        # a LAME/Xing frame first, then silence
        "lame": build_xing_frame(frame_count=12) + silent * 12,
        "silent_mono": us.silent_frame(mode=3) * 9,
    }


STREAMS = _streams()
CHECKS = ["bitstream", "native", "exact", "golden", "lameinfo", "checkpoint"]


def _plain(x):
    """x as plain data that compares equal across the two packages:
    dataclasses field by field, enums by name and value, arrays by dtype,
    shape and bytes."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _header_fields(h) -> dict:
    """Every property of a FrameHeader, and its zero-argument methods."""
    out = {"word": h.word}
    for name, attr in vars(type(h)).items():
        if name.startswith("_"):
            continue
        if isinstance(attr, property):
            out[name] = _plain(getattr(h, name))
        elif callable(attr) and attr.__code__.co_argcount == 1:
            out[name] = _plain(getattr(h, name)())
    return out


def _frames(pkg, data: bytes) -> list:
    """Every frame the package's pure-Python parser reads, then the name of
    the exception that ended the stream."""
    src = pkg.Source(io.BytesIO(data))
    src.skip_tags()
    reader = importlib.import_module(pkg.__name__ + ".parser").FrameReader()
    out = []
    while True:
        try:
            f = reader.read(src, src.pos)
        except Exception as e:  # noqa: BLE001 - compared by class name
            out.append(("end", type(e).__name__, str(e)))
            return out
        out.append((_header_fields(f.header), _plain(f.side_info),
                    _plain(f.main_data), f.start_position))


def _native_arrays(lib, data: bytes) -> list:
    """What the C++ parser gives on every interface of one stream."""
    out = [_plain(list(lib.index_stream(data)))]
    out.append(_plain(list(lib.NativeParser(data).parse_all(chunk=7))))
    p = lib.NativeParser(data)
    while True:
        sp = np.zeros((5, 1152), np.int16)
        side = np.zeros((5, consts.SIDE_WIDTH), np.int16)
        n = p.parse_packed_into(sp, side)
        out.append(("packed", n, _plain(sp), _plain(side), p.tell()))
        if n == 0:
            break
    p = lib.NativeParser(data)
    try:
        while True:
            tail = np.zeros((6, consts.SP8_TAIL_WIDTH), np.int8)
            head = np.zeros((6, consts.HEAD_WIDTH), np.int16)
            side8 = np.zeros((6, consts.SIDE8_WIDTH), np.uint8)
            n = p.parse_packed8_into(tail, head, side8)
            out.append(("packed8", n, _plain(tail), _plain(head), _plain(side8)))
            if n == 0:
                break
            # the fused wire's tail transpose, both channel layouts
            for nch in (1, 2):
                buf = np.zeros((1, nch * 300 * 6 + 8), np.uint8)
                ok = lib.pack_fused_tail(np.ascontiguousarray(tail[None]), buf, 300, nch)
                out.append(("fused_tail", nch, ok, _plain(buf)))
    except OverflowError as e:
        out.append(("overflow", str(e)))
    bp = lib.BatchParser([data, data])
    while True:
        s, cap = 2, 4
        arrays = (np.zeros((s, cap, consts.SP8_TAIL_WIDTH), np.int8),
                  np.zeros((s, cap, consts.HEAD_WIDTH), np.int16),
                  np.zeros((s, cap, consts.SIDE8_WIDTH), np.uint8),
                  np.zeros(s, np.int32))
        try:
            n = bp.parse_chunk_into(*arrays)
        except OverflowError as e:
            out.append(("batch overflow", str(e)))
            break
        out.append(("batch", n, _plain(list(arrays))))
        if n == 0:
            break
    bp.close()
    return out


def _lame(mod, data: bytes):
    try:
        info = mod.parse_from_reader(io.BytesIO(data))
    except Exception as e:  # noqa: BLE001 - compared by class name
        return ("raised", type(e).__name__, str(e))
    return (_plain(info), info.total_delay(), info.total_padding(),
            info.has_lame_info, info.seek_point(0.37, len(data)))


def _checkpoints(decoder_cls, data: bytes, backend: str) -> list:
    """checkpoint_bytes at the start, mid-stream and at the end, and the
    PCM read between them."""
    d = decoder_cls(data, backend=backend)
    out = [d.checkpoint_bytes()]
    out.append(d.read(4608 * 2 + 1000))
    out.append(d.checkpoint_bytes())
    out.append(d.read_all())
    out.append(d.checkpoint_bytes())
    return out


def _run(check: str, data: bytes):
    """(the port's result, the JAX package's result) of one check."""
    if check == "bitstream":
        return _frames(bitstream, data), _frames(jax_bitstream, data)
    if check == "native":
        return _native_arrays(native, data), _native_arrays(jax_native, data)
    if check in ("exact", "golden"):
        port = go_mp3_tpu_torch.Decoder(data, backend=check).read_all()
        return port, go_mp3_tpu.Decoder(data, backend=check).read_all()
    if check == "lameinfo":
        return _lame(lameinfo, data), _lame(jax_lameinfo, data)
    assert check == "checkpoint"
    return tuple([_checkpoints(cls, data, b) for b in ("exact", "golden")]
                 for cls in (go_mp3_tpu_torch.Decoder, go_mp3_tpu.Decoder))


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_port_copy_equals_jax_package(stream, check):
    port, ref = _run(check, STREAMS[stream])
    assert port == ref
    if check in ("exact", "golden"):
        assert len(port) > 0


def test_streams_reach_every_path():
    """The streams above cover what the checks claim: a LAME tag, lines
    past int8, tags around the audio, MPEG-1 and MPEG-2."""
    assert _lame(lameinfo, STREAMS["lame"])[0][1]["lame_version"] == "LAME3.100"
    _, spectra, *_ = native.NativeParser(STREAMS["escape_heavy"]).parse(4)
    assert np.abs(spectra).max() > 127
    rates = {native.index_stream(d)[2] for d in STREAMS.values()}
    assert {44100, 22050} <= rates
    tagged = go_mp3_tpu_torch.Decoder(STREAMS["escape_tagged"], backend="exact")
    plain = go_mp3_tpu_torch.Decoder(STREAMS["escape"], backend="exact")
    assert tagged.read_all() == plain.read_all() * 2


def test_errors_are_the_ports_own():
    """The port raises its own error classes, with the JAX package's
    names and messages."""
    with pytest.raises(consts.MP3Error) as port_err:
        go_mp3_tpu_torch.Decoder(b"\x00" * 4096, backend="exact")
    with pytest.raises(jax_consts.MP3Error) as ref_err:
        go_mp3_tpu.Decoder(b"\x00" * 4096, backend="exact")
    assert not isinstance(port_err.value, jax_consts.MP3Error)
    assert str(port_err.value) == str(ref_err.value)
