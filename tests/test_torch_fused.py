"""The port's fused corpus path (the one-buffer wire, K4's plain version,
the k-chunk segment, the lane groups and the corpus options) against
go_mp3_tpu's, on the CPU, with in-repo inputs only.

Integers and bytes must be identical (tolerance 0). Decoded PCM must be
bit-identical to the port's own fused=False result (the same plain chain
on the same granules) and ISO fully compliant (RMS < 0.289 LSB, max
difference <= 2 LSB) against JAX's decode_corpus_fast with the same
options and against the exact C++ backend."""

import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_mp3_tpu.ops.granule as JG  # noqa: E402
import go_mp3_tpu.parallel.corpus as JC  # noqa: E402
import util_synth as U  # noqa: E402
from go_mp3_tpu import Decoder as JaxDecoder  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.ops import kernels as K  # noqa: E402
from go_mp3_tpu_torch.ops import wire as W  # noqa: E402
from go_mp3_tpu_torch.parallel import segment as SEG  # noqa: E402
from go_mp3_tpu_torch.reference import (  # noqa: E402
    FULL_MAXDIFF,
    FULL_RMS,
    index_stream,
    iso_metrics,
)

CONF = Path(__file__).resolve().parent.parent / "conformance"
BUCKETS = (64, 192, 448, 512)


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


def _assert_compliant(a: bytes, b: bytes) -> None:
    rms, maxdiff = iso_metrics(a, b)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


def _parsed_chunk(seed: int, s: int, t: int, need: int):
    """Seeded int8-interface arrays whose tail is zero past line `need`
    of each channel, some lines up to the edge nonzero."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(-128, 128, (s, t, 2, 512), dtype=np.int8)
    tail *= rng.random((s, t, 2, 512)) < 0.3
    tail[..., need:] = 0
    if need:
        tail[rng.integers(s), rng.integers(t), rng.integers(2), need - 1] = 7
    head = rng.integers(-32768, 32768, (s, t, 128), dtype=np.int16)
    side = rng.integers(0, 256, (s, t, 168), dtype=np.uint8)
    return tail.reshape(s, t, 1024), head, side


def _mono_planes(tail, head):
    """The parser's mono contract: channel 1 of every plane is zero."""
    tail = tail.copy().reshape(*tail.shape[:2], 2, 512)
    tail[:, :, 1] = 0
    head = head.copy().reshape(*head.shape[:2], 2, 64)
    head[:, :, 1] = 0
    return tail.reshape(*tail.shape[:2], 1024), head.reshape(*head.shape[:2], 128)


# -- (a) the wire builders -----------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("t", [37, 64])
@pytest.mark.parametrize("lines", [64, 301, 464, 512])
def test_wire_builder_bytes_equal_jax(lines, t, mono, native):
    tail, head, side = _parsed_chunk(lines * 7 + t, 5, t, 512)
    port = W.build_fused_chunk_mono if mono else W.build_fused_chunk
    ref = JC.build_fused_chunk_mono if mono else JC.build_fused_chunk
    got = port(tail, head, side, lines, native=native)
    want = ref(tail, head, side, lines)
    nbytes = (JG.fused_stream_nbytes_mono if mono else JG.fused_stream_nbytes)(t, lines)
    assert got.shape == want.shape == (5, nbytes)
    assert W.stream_nbytes(t, lines, mono) == nbytes
    assert np.array_equal(got, want)
    # into a chunk of a larger stack, as decode_corpus_fast packs
    stack = np.full((3,) + want.shape, 0xAB, np.uint8)
    port(tail, head, side, lines, out=stack[1], native=native)
    assert np.array_equal(stack[1], want) and (stack[0] == 0xAB).all()


def test_wire_builder_rejects_a_strided_out():
    tail, head, side = _parsed_chunk(1, 2, 8, 512)
    out = np.empty((2, 2 * W.fused_stream_nbytes(8)), np.uint8)[:, ::2]
    with pytest.raises(ValueError):
        W.build_fused_chunk(tail, head, side, out=out)


# -- (b) the tail helpers --------------------------------------------------------


@pytest.mark.parametrize("need", [0, 1, 63, 64, 65, 301, 448, 449, 511, 512])
def test_tail_helpers_equal_jax(need):
    tail, _, side = _parsed_chunk(need, 4, 16, need)
    assert W.tail_need_lines(tail) == JC.tail_need_lines(tail) == need
    for buckets in (BUCKETS, (448, 512), (464, 512), (600,)):
        assert W.tail_cap_lines(tail, buckets) == JC.tail_cap_lines(tail, buckets)
        assert (W.bucket_tail_lines(need, buckets)
                == JC.bucket_tail_lines(need, buckets))
    rng = np.random.default_rng(need)
    valids = rng.integers(0, 17, 4).astype(np.int32)
    side[..., 2] |= 4
    assert W.chunk_all_mono(side, valids) == JC.chunk_all_mono(side, valids) is True
    s = int(np.argmax(valids))
    if valids[s] < 16:  # a stereo granule in a padding row is not looked at
        side[s, valids[s], 2] = 0
        assert W.chunk_all_mono(side, valids) is True
    if valids[s]:
        side[s, valids[s] - 1, 2] = 0
        assert W.chunk_all_mono(side, valids) == JC.chunk_all_mono(side, valids) is False


def test_tail_helpers_cases_of_the_jax_tests():
    """tests/test_parallel.py's tail_cap / tail_need / bucket cases."""
    sp = np.zeros((2, 4, 1024), np.int8)
    assert W.tail_cap_lines(sp, (64, 448, 512)) == 64
    assert W.tail_need_lines(sp) == 0
    sp.reshape(2, 4, 2, 512)[1, 2, 1, 300] = 5
    assert W.tail_cap_lines(sp, (64, 448, 512)) == 448
    assert W.tail_need_lines(sp) == 301
    sp.reshape(2, 4, 2, 512)[0, 0, 0, 460] = -3
    assert W.tail_cap_lines(sp, (64, 448, 512)) == 512
    assert W.bucket_tail_lines(301, (64, 448, 512)) == 448
    assert W.bucket_tail_lines(513, (64, 448, 512)) == 512
    assert W.bucket_tail_lines(0, (600,)) == 512


# -- (c) the unpack (K4's plain version) -------------------------------------------


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
@pytest.mark.parametrize("t,lines", [(37, 301), (37, 512), (64, 464), (64, 64), (37, 1)])
def test_unpack_ref_equals_jax_unpack(t, lines, mono):
    """Exact integers; odd T with odd L makes a mono row odd-sized, so its
    head region starts at odd offsets."""
    rng = np.random.default_rng(t * 1000 + lines)
    n = (JG.fused_stream_nbytes_mono if mono else JG.fused_stream_nbytes)(t, lines)
    buf = rng.integers(0, 256, (3, n), dtype=np.uint8)
    jax_unpack = JG.unpack_fused_mono if mono else JG.unpack_fused
    want = [np.asarray(a) for a in jax_unpack(buf, t, lines)]
    port = P.unpack_fused_mono_ref if mono else P.unpack_fused_ref
    got = port(torch.from_numpy(buf), t, lines)
    via_wrapper = K.unpack_fused(torch.from_numpy(buf), t, lines, mono)
    for g, w, v in zip(got, want, via_wrapper):
        assert g.is_contiguous()
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
        assert torch.equal(g, v)


@pytest.mark.parametrize("mono", [False, True], ids=["stereo", "mono"])
def test_unpack_ref_round_trips_the_wire(mono):
    tail, head, side = _parsed_chunk(3, 4, 37, 301)
    if mono:
        tail, head = _mono_planes(tail, head)
    build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
    buf = torch.from_numpy(build(tail, head, side, 301))
    unpack = P.unpack_fused_mono_ref if mono else P.unpack_fused_ref
    for g, w in zip(unpack(buf, 37, 301), (tail, head, side)):
        assert np.array_equal(g.numpy(), w)


def test_unpack_wrapper_checks_its_input():
    buf = torch.zeros((2, W.fused_stream_nbytes(8, 64)), dtype=torch.uint8)
    K.reset_launch_counts()
    K.unpack_fused(buf, 8, 64)
    assert K.launch_counts()["unpack_fused"] == 0  # CPU: the plain version
    with pytest.raises(ValueError):
        K.unpack_fused(buf, 8, 65)  # row size of another width
    with pytest.raises(ValueError):
        K.unpack_fused(buf, 8, 64, mono=True)
    with pytest.raises(ValueError):
        K.unpack_fused(buf, 8, 513)
    with pytest.raises(TypeError):
        K.unpack_fused(buf.to(torch.int8), 8, 64)


# -- K5's plain form ------------------------------------------------------------------


SEG_T, SEG_K = 16, 3
SEG_GROUPS = ((3, 301, False), (2, 64, True))  # (lanes, width, mono)


def _segment_inputs(seed: int):
    """A 3-chunk segment of two lane groups (stereo 3 lanes at L = 301,
    mono 2 lanes at L = 64) of seeded synthetic granules, the last chunk a
    valid = 0 padding chunk, and a seeded state: numpy (bufs [k, S_g, n],
    valids [k, S_g], (store, v_fifo)) per group."""
    import torch_synthetic as syn

    t, k = SEG_T, SEG_K
    rng = np.random.default_rng(seed)
    out = []
    for gi, (s, lines, mono) in enumerate(SEG_GROUPS):
        rows = []
        for c in range(k):
            v = rng.integers(1, t + 1, s).astype(np.int32)
            sp, sd = syn.random_chunk(seed * 100 + 10 * gi + c, s, t, v)
            tail, head, side = syn.to_packed8(sp, sd)
            tail = tail.reshape(s, t, 2, 512).copy()
            tail[..., lines:] = 0
            tail = tail.reshape(s, t, 1024)
            if mono:
                tail, head = _mono_planes(tail, head)
            build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
            rows.append(build(tail, head, side, lines))
        vk = rng.integers(0, t + 1, (k, s)).astype(np.int32)
        vk[-1] = 0
        state = ((rng.standard_normal((s, 2, 32, 18)) * 0.05).astype(np.float32),
                 (rng.standard_normal((s, 2, 16, 64)) * 0.05).astype(np.float32))
        out.append((np.stack(rows), vk, state))
    return out


def _run_segment(inputs):
    bufs = [torch.from_numpy(b) for b, _, _ in inputs]
    valids = [torch.from_numpy(v) for _, v, _ in inputs]
    states = [P.state_from_numpy(*st, "cpu") for _, _, st in inputs]
    widths = tuple(g[1] for g in SEG_GROUPS)
    monos = tuple(g[2] for g in SEG_GROUPS)
    return bufs, valids, states, SEG.run_segment_eager(
        bufs, valids, states, SEG_T, widths, monos)


def test_segment_eager_equals_chunk_by_chunk():
    """run_segment_eager gives the same PCM and state as
    decode_chunk_fused chunk by chunk, and the padding chunk leaves the
    state as it was."""
    bufs, valids, states, (pcm, out) = _run_segment(_segment_inputs(5))
    for g, (s, lines, mono) in enumerate(SEG_GROUPS):
        st = states[g]
        for c in range(SEG_K):
            want, new = K.decode_chunk_fused(bufs[g][c], st, valids[g][c], SEG_T,
                                             lines, mono)
            assert torch.equal(pcm[g][c], want)
            if c == SEG_K - 1:
                assert torch.equal(new.store, st.store)
                assert torch.equal(new.v_fifo, st.v_fifo)
            st = new
        assert torch.equal(out[g].store, st.store)
        assert torch.equal(out[g].v_fifo, st.v_fifo)


@pytest.mark.parametrize("seed", [5, 6])
def test_segment_matches_jax_fused_chunks(seed):
    """K5's plain form against JAX's decode_chunk_fused_batch_impl and its
    mono twin, chunk by chunk with the state carried. The tolerances are
    test_torch_granule.py's for the same white-noise synthetic spectra
    (PCM_MAXDIFF, PCM_RMS over a stream-chunk's valid rows; STATE_REL of
    the state's scale); real streams are held to ISO full below."""
    import functools

    import jax
    import jax.numpy as jnp
    from test_torch_granule import PCM_MAXDIFF, PCM_RMS, STATE_REL

    inputs = _segment_inputs(seed)
    _, _, _, (pcm, out) = _run_segment(inputs)
    for g, ((s, lines, mono), (bufs, valids, state)) in enumerate(
            zip(SEG_GROUPS, inputs)):
        impl = JG.decode_chunk_fused_mono_batch_impl if mono else \
            JG.decode_chunk_fused_batch_impl
        step = jax.jit(functools.partial(impl, t=SEG_T, tail_lines=lines))
        j_state = JG.DecodeState(*map(jnp.asarray, state))
        for c in range(SEG_K):
            j_pcm, j_state = step(jnp.asarray(bufs[c]), j_state,
                                  jnp.asarray(valids[c]))
            j_pcm = np.asarray(j_pcm).astype(np.int32)
            for lane in range(s):
                n = valids[c, lane] * 576
                if n:
                    d = (j_pcm[lane, :n] - pcm[g][c, lane, :n].numpy()).astype(np.float64)
                    assert np.abs(d).max() <= PCM_MAXDIFF
                    assert np.sqrt((d ** 2).mean()) < PCM_RMS
        for ref, got in zip((j_state.store, j_state.v_fifo), out[g]):
            ref = np.asarray(ref)
            assert np.abs(ref - got.numpy()).max() <= STATE_REL * np.abs(ref).max()


def test_segment_graph_needs_cuda_tensors():
    slots = SEG.static_slots(2, 8, (3,), "cpu")
    with pytest.raises(ValueError):
        SEG.SegmentGraph(8, (512,), (False,), *slots)


# -- (d)-(g) decode_corpus_fast ---------------------------------------------------------


@pytest.fixture(scope="module")
def lanes():
    """Caller order: a mono lane, two stereo lanes, a mono lane. The
    escape lanes start at stereo frames (its frames 8-11), so mono_split
    holds; their mono frames ride the stereo wire."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes() * 4
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes() * 4
    return [_rotate(lowrate, 1), _rotate(escape, 8), _rotate(escape, 22),
            _rotate(lowrate, 43)]


CHUNK_T = 32


@pytest.fixture(scope="module")
def unfused(lanes):
    return decode_corpus_fast(lanes, chunk_t=CHUNK_T, fused=False, device="cpu")


@pytest.fixture(scope="module")
def exact(lanes):
    return [JaxDecoder(d, backend="exact").read_all() for d in lanes]


OPTIONS = [
    {},
    {"mono_split": False},
    {"fused": False, "mono_split": False},
    {"tail_buckets": BUCKETS},
    {"tail_buckets": BUCKETS, "mono_split": False},
    {"n_threads": 2},
    {"n_threads": 3},
    {"drain": 2},
    {"drain": 4},
    {"drain": 2, "tail_buckets": BUCKETS},
    {"drain": 4, "tail_buckets": BUCKETS, "n_threads": 3},
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(
    f"{k}={v}" for k, v in o.items()) or "defaults")
def test_corpus_options(lanes, unfused, exact, opts):
    got = decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu", **opts)
    assert got.pcm == unfused.pcm and got.granules == unfused.granules == 400
    assert set(got.phase_seconds) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    ref = JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T, **opts)
    assert got.granules == ref.granules and got.samples == ref.samples
    for a, b, c in zip(got.pcm, ref.pcm, exact):
        _assert_compliant(a, b)
        _assert_compliant(a, c)
    if opts.get("fused", True):
        split = opts.get("mono_split", True)
        assert all(len(w) == (2 if split else 1) for w in got.chunk_widths)
        assert len(got.chunk_widths) == 4  # ceil(104 / 32) chunks
        assert got.graph_replays == 0  # no graph on the CPU


def test_tail_buckets_cap_the_wire(lanes, unfused):
    full = decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")
    capped = decode_corpus_fast(lanes, chunk_t=CHUNK_T, tail_buckets=BUCKETS,
                                device="cpu")
    assert capped.pcm == unfused.pcm
    assert capped.wire_bytes < full.wire_bytes
    assert any(w != (512, 512) for w in capped.chunk_widths)
    # drain: one width per segment, the bucket of its largest extent
    drained = decode_corpus_fast(lanes, chunk_t=CHUNK_T, tail_buckets=BUCKETS,
                                 drain=2, device="cpu")
    assert drained.chunk_widths[0] == drained.chunk_widths[1]
    for seg in range(2):
        pair = capped.chunk_widths[2 * seg: 2 * seg + 2]
        assert drained.chunk_widths[2 * seg] == tuple(map(max, *pair))


@pytest.mark.parametrize("drain", [None, 2])
def test_fetch_false_returns_caller_order_pcm(lanes, unfused, drain):
    """(pcm [C, S, T*576, 2], valids [C, S]) in the caller's order (a mono
    lane first), equal to the fetched bytes and to JAX's valids; drain is
    ignored with fetch=False, as in JAX."""
    res = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False, drain=drain,
                             device="cpu")
    pcm, valids = res
    assert res.stats.granules == unfused.granules and res.stats.pcm == [b""] * 4
    assert res.stats.phase_seconds["d2h"] == 0 and res.stats.wire_bytes > 0
    _, jax_valids = JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False)
    assert pcm.dtype == torch.int16
    assert pcm.shape == (4, len(lanes), CHUNK_T * 576, 2)
    assert valids.dtype == np.int32 and np.array_equal(valids, np.asarray(jax_valids))
    for s in range(len(lanes)):
        got = b"".join(pcm[c, s, : valids[c, s] * 576].numpy().tobytes()
                       for c in range(len(valids)))
        assert got == unfused.pcm[s]


def test_fetch_false_unfused_stacks_chunks(lanes, unfused):
    res = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False, fused=False,
                             device="cpu")
    pcm, valids = res
    assert pcm.shape == (4, len(lanes), CHUNK_T * 576, 2)
    assert int(valids.sum()) == res.stats.granules == unfused.granules
    for s in range(len(lanes)):
        got = b"".join(pcm[c, s, : valids[c, s] * 576].numpy().tobytes()
                       for c in range(len(valids)))
        assert got == unfused.pcm[s]


def test_mono_split_mismatch_reruns_unsplit():
    """A lane whose first frame is mono turns stereo: the mono wire cannot
    carry it, so the corpus reruns with one stereo group (the stream of
    tests/test_parallel.py's mismatch test)."""
    tricky = U.escape_heavy_frame(
        n_pairs=8, linbit_value=500, global_gain=148
    ) + b"".join(U.silent_frame(mode=0) for _ in range(6))
    plain = b"".join(U.silent_frame(mode=0) for _ in range(8))
    streams = [plain, tricky]
    ref = decode_corpus_fast(streams, chunk_t=8, mono_split=False, device="cpu")
    got = decode_corpus_fast(streams, chunk_t=8, device="cpu")
    assert got.pcm == ref.pcm and got.granules == ref.granules
    assert all(len(w) == 1 for w in got.chunk_widths)
    want = JC.decode_corpus_fast(streams, chunk_t=8)
    for a, b in zip(got.pcm, want.pcm):
        _assert_compliant(a, b)


def test_fused_overflow_falls_back_to_int16_interface():
    data = U.escape_heavy_frame() * 3
    got = decode_corpus_fast([data], chunk_t=16, device="cpu")
    assert got.granules == 6
    _assert_compliant(got.pcm[0], JC.decode_corpus_fast([data], chunk_t=16).pcm[0])


def test_signature_matches_jax():
    """Every parameter of JAX's decode_corpus_fast, mesh fourth, in its
    order, kind and default, then a keyword-only device: a positional call
    written for JAX binds the same parameters on the port."""
    jax_params = list(inspect.signature(JC.decode_corpus_fast).parameters.values())
    port_params = list(inspect.signature(decode_corpus_fast).parameters.values())
    assert [p.name for p in port_params] == [p.name for p in jax_params] + ["device"]
    assert port_params[3].name == "mesh"
    for p, q in zip(port_params, jax_params):
        assert (p.kind, p.default) == (q.kind, q.default), p.name
    assert port_params[-1].kind is inspect.Parameter.KEYWORD_ONLY
    assert port_params[-1].default is None
    bound = inspect.signature(decode_corpus_fast).bind([b""], 64, True, None, 4)
    assert bound.arguments["mesh"] is None and bound.arguments["drain"] == 4


def test_empty_streams_and_bad_drain():
    res = decode_corpus_fast([b"", b""], device="cpu")
    assert res.pcm == [b"", b""] and res.granules == 0
    with pytest.raises(ValueError):
        decode_corpus_fast([b""], drain=0, device="cpu")
