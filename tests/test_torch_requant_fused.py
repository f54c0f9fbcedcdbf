"""K1 on the fused wire rows, the empty chunk (T = 0) and the port's guards
around its native library, on the CPU, against go_mp3_tpu.

- requant_stereo_fused (K1's fourth input; its CPU route is the plain
  version) against JAX's _requantize and _stereo on
  batch_from_packed8(*unpack_fused(_mono)(buf, t, L)), within
  tests/test_stage_parity.py's bounds: requantize 2e-5 and stereo 1e-6 of
  each granule's scale; and bit-identical to unpack_fused -> requant_stereo
  and to the int16 route on the same granules.
- A chunk of T = 0 granules through every wrapper and both chunk decoders:
  empty outputs, and the state given back (a copy), as JAX's
  decode_chunk_packed_batch and decode_chunk_fused_batch_impl give it.
- native/lib.py's entry points raise TypeError/ValueError on a wrong dtype,
  a wrong shape or a non-contiguous array under `python -O` too.
- The streaming parser's limits: > 64 KiB of junk ends the stream with
  nothing buffered, and a 5 MB ID3v2 tag fed in 64 KiB pieces is consumed
  as it arrives, the audio after it parsed as if alone.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import go_mp3_tpu.ops.granule as JG  # noqa: E402
import torch_synthetic as syn  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.ops import kernels as K  # noqa: E402
from go_mp3_tpu_torch.ops import wire as W  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ESCAPE = (ROOT / "conformance" / "synthetic_escape.mp3").read_bytes()
REQUANT_REL, STEREO_REL = 2e-5, 1e-6  # test_stage_parity.py's bounds


def _wire(seed: int, s_dim: int, t_dim: int, lines: int, mono: bool):
    """Seeded synthetic granules as fused rows (numpy u8 [S, n]) and the
    int8 arrays they carry: tail lines past `lines` zero, and channel 1
    zero on a mono row (the wire's contract)."""
    rng = np.random.default_rng(seed)
    valid = rng.integers(1, t_dim + 1, s_dim).astype(np.int32)
    tail, head, side = syn.to_packed8(*syn.random_chunk(seed, s_dim, t_dim, valid))
    tail = tail.reshape(s_dim, t_dim, 2, 512).copy()
    tail[..., lines:] = 0
    head = head.reshape(s_dim, t_dim, 2, 64).copy()
    if mono:
        tail[:, :, 1] = 0
        head[:, :, 1] = 0
    arrays = (tail.reshape(s_dim, t_dim, 1024), head.reshape(s_dim, t_dim, 128), side)
    build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
    return build(*arrays, lines), arrays


def _rel_per_granule(got: np.ndarray, ref: np.ndarray) -> float:
    """max |got - ref| over each granule / that granule's max |ref| (0 where
    both are 0)."""
    err = np.abs(got - ref).reshape(*ref.shape[:2], -1).max(-1)
    scale = np.abs(ref).reshape(*ref.shape[:2], -1).max(-1)
    assert (err[scale == 0] == 0).all()
    return float((err / np.maximum(scale, 1e-30)).max())


# -- K1's fused route ------------------------------------------------------------


@pytest.mark.parametrize("t_dim", [240, 37])
@pytest.mark.parametrize("lines", [512, 464, 301, 0])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_fused_route_within_stage_bounds_of_jax(mono, lines, t_dim):
    buf, _ = _wire(lines + t_dim + mono, 3, t_dim, lines, mono)
    unpack = JG.unpack_fused_mono if mono else JG.unpack_fused
    jb = jax.vmap(JG.batch_from_packed8)(*unpack(jnp.asarray(buf), t_dim, lines))
    x_req, ginfo = K.requant_stereo_fused(torch.from_numpy(buf), t_dim, lines, mono,
                                          stereo=False)
    x_all, ginfo_all = K.requant_stereo_fused(torch.from_numpy(buf), t_dim, lines, mono)
    assert x_req.shape == (3, t_dim, 2, 576) and torch.equal(ginfo, ginfo_all)
    want_req = np.asarray(jax.vmap(JG._requantize)(jb))
    assert _rel_per_granule(x_req.numpy(), want_req) <= REQUANT_REL
    # the stereo part on the port's own requantized input, as
    # test_stage_parity feeds each stage its predecessor's output
    want_st = np.asarray(jax.vmap(JG._stereo)(jb, jnp.asarray(x_req.numpy())))
    assert _rel_per_granule(x_all.numpy(), want_st) <= STEREO_REL


@pytest.mark.parametrize("t_dim,lines", [(240, 512), (37, 301), (16, 1)])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_fused_route_is_unpack_then_k1_bit_for_bit(mono, t_dim, lines):
    buf, arrays = _wire(7 * t_dim + lines, 4, t_dim, lines, mono)
    rows = torch.from_numpy(buf)
    p8 = K.unpack_fused(rows, t_dim, lines, mono)
    p16 = tuple(map(torch.from_numpy, syn.from_packed8(*arrays)))
    for stereo in (False, True):
        got = K.requant_stereo_fused(rows, t_dim, lines, mono, stereo)
        for want in (K.requant_stereo(p8, stereo), K.requant_stereo(p16, stereo)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_route_counts_and_checks_its_input():
    buf = torch.zeros((2, W.fused_stream_nbytes(8, 64)), dtype=torch.uint8)
    K.reset_launch_counts()
    x, ginfo = K.requant_stereo_fused(buf, 8, 64)
    assert x.shape == (2, 8, 2, 576) and ginfo.shape == (2, 8)
    assert K.all_counts() == dict.fromkeys(K.all_counts(), 0)  # CPU: plain version
    with pytest.raises(ValueError):
        K.requant_stereo_fused(buf, 8, 65)
    with pytest.raises(ValueError):
        K.requant_stereo_fused(buf, 8, 64, mono=True)
    with pytest.raises(ValueError):
        K.requant_stereo_fused(buf, 8, 513)
    with pytest.raises(TypeError):
        K.requant_stereo_fused(buf.to(torch.int8), 8, 64)


def test_segment_graph_counts_each_k1_route():
    """all_counts/add_counts, which SegmentGraph uses to replay its
    captured launches, carry K1's routes with the kernels."""
    K.reset_launch_counts()
    K.add_counts({"requant_stereo": 2, "fused": 2, "synth": 1, "chain": 3,
                  "chain_fused": 3})
    assert K.all_counts() == {"requant_stereo": 2, "hybrid": 0, "synth": 1,
                              "unpack_fused": 0, "chain": 3, "energy": 0, "int16": 0,
                              "granule_batch": 0, "fused": 2, "chain_int16": 0,
                              "chain_granule_batch": 0, "chain_fused": 3}
    assert K.requant_stereo.fused_launches == 2 and K.chain.fused_launches == 3
    K.reset_launch_counts()
    assert not any(K.all_counts().values())


# -- T = 0 -------------------------------------------------------------------------


def _state(s_dim: int, seed: int = 3):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32))


def _assert_state_returned(got: P.DecodeState, given: P.DecodeState, jax_state):
    for g, x, j in zip(got, given, jax_state):
        assert torch.equal(g, x) and g.data_ptr() != x.data_ptr()  # a copy
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_decode_chunk_of_no_granules_returns_the_state_like_jax():
    s_dim = 2
    store, fifo = _state(s_dim)
    sp = np.zeros((s_dim, 0, 1152), np.int16)
    side = np.zeros((s_dim, 0, 144), np.int16)
    valid = np.zeros(s_dim, np.int32)
    j_pcm, j_state = JG.decode_chunk_packed_batch(
        jnp.asarray(sp), jnp.asarray(side), JG.DecodeState(jnp.asarray(store), jnp.asarray(fifo)),
        jnp.asarray(valid))
    state = P.state_from_numpy(store, fifo, "cpu")
    p16 = (torch.from_numpy(sp), torch.from_numpy(side))
    p8 = tuple(map(torch.from_numpy, syn.to_packed8(sp, side)))
    batch = P.GranuleBatch(*(f.contiguous() for f in P.batch_from_packed(*p16)))
    for packed in (p16, p8, batch):
        pcm, got = K.decode_chunk(packed, state, torch.from_numpy(valid))
        assert pcm.shape == np.asarray(j_pcm).shape == (s_dim, 0, 2)
        _assert_state_returned(got, state, j_state)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_decode_chunk_fused_of_no_granules_returns_the_state_like_jax(mono):
    s_dim, lines = 3, 301
    store, fifo = _state(s_dim, 4)
    buf = np.zeros((s_dim, W.stream_nbytes(0, lines, mono)), np.uint8)
    valid = np.zeros(s_dim, np.int32)
    jax_decode = JG.decode_chunk_fused_mono_batch_impl if mono else JG.decode_chunk_fused_batch_impl
    j_pcm, j_state = jax_decode(
        jnp.asarray(buf), JG.DecodeState(jnp.asarray(store), jnp.asarray(fifo)),
        jnp.asarray(valid), t=0, tail_lines=lines)
    state = P.state_from_numpy(store, fifo, "cpu")
    pcm, got = K.decode_chunk_fused(torch.from_numpy(buf), state,
                                    torch.from_numpy(valid), 0, lines, mono)
    assert pcm.shape == np.asarray(j_pcm).shape == (s_dim, 0, 2)
    _assert_state_returned(got, state, j_state)
    unpack = JG.unpack_fused_mono if mono else JG.unpack_fused
    for got_a, want in zip(K.unpack_fused(torch.from_numpy(buf), 0, lines, mono),
                           unpack(jnp.asarray(buf), 0, lines)):
        assert got_a.shape == np.asarray(want).shape and got_a.numpy().dtype == want.dtype


def test_k1_k2_k3_of_no_granules():
    s_dim = 2
    store, fifo = _state(s_dim, 5)
    state = P.state_from_numpy(store, fifo, "cpu")
    valid = torch.zeros(s_dim, dtype=torch.int32)
    x, ginfo = K.requant_stereo((torch.zeros((s_dim, 0, 1152), dtype=torch.int16),
                                 torch.zeros((s_dim, 0, 144), dtype=torch.int16)))
    assert x.shape == (s_dim, 0, 2, 576) and ginfo.shape == (s_dim, 0)
    x18, st = K.hybrid(x, ginfo, state.store, valid)
    assert x18.shape == (s_dim, 0, 2, 32, 18)
    assert torch.equal(st, state.store) and st.data_ptr() != state.store.data_ptr()
    out = torch.empty((s_dim, 0, 2), dtype=torch.int16)
    pcm, vf = K.synth(x18, ginfo, state.v_fifo, valid, out=out)
    assert pcm.shape == (s_dim, 0, 2)
    assert torch.equal(vf, state.v_fifo) and vf.data_ptr() != state.v_fifo.data_ptr()


# -- native/lib.py under python -O ------------------------------------------------

_GUARD_SCRIPT = """
import sys
import numpy as np
from go_mp3_tpu_torch.native import lib
assert sys.flags.optimize >= 1
data = open(sys.argv[1], "rb").read() * 4
bad = {"dtype": TypeError, "shape": ValueError, "contiguous": ValueError}

def expect(kind, fn, *args):
    try:
        fn(*args)
    except bad[kind]:
        return
    raise SystemExit(f"{kind}: no {bad[kind].__name__}")

def variants(arrays, i):
    # the arrays with array i of a wrong dtype, a wrong shape, not contiguous
    a = arrays[i]
    wrong_dtype = a.astype(np.float64)
    wrong_shape = np.zeros(a.shape[:-1] + (a.shape[-1] + 1,), a.dtype)
    strided = np.zeros(a.shape[:-1] + (2 * a.shape[-1],), a.dtype)[..., ::2]
    for kind, b in (("dtype", wrong_dtype), ("shape", wrong_shape), ("contiguous", strided)):
        yield kind, arrays[:i] + [b] + arrays[i + 1:]

entry = sys.argv[2]
cap = 8
if entry == "parse_into":
    arrays = [np.zeros((cap, 2, 576), np.int16), np.zeros((cap, 2, 22), np.int32),
              np.zeros((cap, 2, 39), np.int32), np.zeros((cap, lib.META_WIDTH), np.int32)]
    fn = lib.NativeParser(data).parse_into
elif entry == "parse_packed_into":
    arrays = [np.zeros((cap, 1152), np.int16), np.zeros((cap, lib.SIDE_WIDTH), np.int16)]
    fn = lib.NativeParser(data).parse_packed_into
elif entry == "parse_packed8_into":
    arrays = [np.zeros((cap, lib.SP8_TAIL_WIDTH), np.int8),
              np.zeros((cap, lib.HEAD_WIDTH), np.int16),
              np.zeros((cap, lib.SIDE8_WIDTH), np.uint8)]
    fn = lib.NativeParser(data).parse_packed8_into
elif entry == "parse_chunk_into":
    arrays = [np.zeros((2, cap, lib.SP8_TAIL_WIDTH), np.int8),
              np.zeros((2, cap, lib.HEAD_WIDTH), np.int16),
              np.zeros((2, cap, lib.SIDE8_WIDTH), np.uint8), np.zeros(2, np.int32)]
    fn = lib.BatchParser([data, data]).parse_chunk_into
elif entry == "dsp_decode":
    arrays = [np.zeros((cap, 2, 576), np.int16), np.zeros((cap, 2, 22), np.int32),
              np.zeros((cap, 2, 39), np.int32), np.zeros((cap, lib.META_WIDTH), np.int32)]
    fn = lib.NativeDsp().decode
elif entry == "dsp_set_state":  # converts dtype and layout itself: shape only
    dsp = lib.NativeDsp()
    expect("shape", dsp.set_state, np.zeros((2, 32, 17), np.float32),
           np.zeros((2, 1024), np.float32))
    expect("shape", dsp.set_state, np.zeros((2, 32, 18), np.float32),
           np.zeros((2, 1023), np.float32))
    dsp.set_state(np.zeros((2, 32, 18)), np.zeros((2, 2048), np.float32)[:, ::2])
    print("ok")
    raise SystemExit(0)
fn(*arrays)  # the right arrays go through
for i in range(len(arrays)):
    for kind, args in variants(list(arrays), i):
        expect(kind, fn, *args)
print("ok")
"""


@pytest.mark.parametrize("entry", ["parse_into", "parse_packed_into", "parse_packed8_into",
                                   "parse_chunk_into", "dsp_decode", "dsp_set_state"])
def test_native_entry_raises_under_python_O(entry):
    """Each array guard of native/lib.py is an explicit raise, so `python -O`
    (which drops asserts) still stops a bad array before C sees it."""
    proc = subprocess.run(
        [sys.executable, "-O", "-c", _GUARD_SCRIPT, str(ROOT / "conformance" / "synthetic_escape.mp3"),
         entry], capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-2000:]


# -- the streaming parser's limits ------------------------------------------------------


def _parse_buffers(cap: int = 64):
    from go_mp3_tpu_torch.native.lib import META_WIDTH

    return (np.zeros((cap, 2, 576), np.int16), np.zeros((cap, 2, 22), np.int32),
            np.zeros((cap, 2, 39), np.int32), np.zeros((cap, META_WIDTH), np.int32))


def test_streaming_sync_limit_is_terminal_with_nothing_buffered():
    """More than 64 KiB that holds no frame sync ends the stream (the
    reference's sync-search limit): eof turns true within ~64 KiB, later
    feeds are dropped (the position stays) and parses give 0."""
    from go_mp3_tpu_torch.native.lib import StreamingNativeParser

    s = StreamingNativeParser()
    arrays = _parse_buffers()
    s.feed(ESCAPE[:4000])
    got = 0
    while (n := s.parse_into(*arrays)) > 0:
        got += n
    assert got > 0
    junk = b"\x00" * 8192
    fed = 0
    while not s.eof and fed < 40:
        s.feed(junk)
        s.parse_into(*arrays)
        fed += 1
    assert s.eof, "the sync limit must end the stream"
    assert fed <= 12, f"took {fed} feeds of 8 KiB to end"
    pos = s.tell()
    for _ in range(64):  # 512 KiB more: not buffered, not parsed
        s.feed(junk)
        assert s.parse_into(*arrays) == 0
    assert s.tell() == pos and s.eof
    s.close()


def test_streaming_giant_id3_tag_is_consumed_as_it_arrives():
    """A 5 MB ID3v2 tag fed in 64 KiB pieces: the position moves through
    it piece by piece, and the audio after it parses to the same granules
    as the audio alone."""
    from go_mp3_tpu_torch.native.lib import NativeParser, StreamingNativeParser

    audio = ESCAPE * 4
    size = 5_000_000
    header = b"ID3\x04\x00\x00" + bytes(
        [(size >> 21) & 0x7F, (size >> 14) & 0x7F, (size >> 7) & 0x7F, size & 0x7F])
    s = StreamingNativeParser()
    arrays = _parse_buffers()
    s.feed(header)
    assert s.parse_into(*arrays) == 0
    piece, fed = b"\x00" * 65536, 0
    while fed < size:
        n = min(len(piece), size - fed)
        s.feed(piece[:n])
        fed += n
        assert s.parse_into(*arrays) == 0
        assert s.tell() >= len(header) + fed - len(piece)  # consumed as it came
    assert s.tell() >= size
    s.feed(audio, eof=True)
    spectra = []
    while (n := s.parse_into(*arrays)) > 0:
        spectra.append(arrays[0][:n].copy())
    s.close()
    alone = NativeParser(audio)
    ref = alone.parse_all()[0]
    alone.close()
    assert spectra and np.array_equal(np.concatenate(spectra), ref)
