"""The chain kernel's wrapper (kernels.chain, K5: K1 -> K2 -> K3 in one
launch) on the CPU, against go_mp3_tpu.

- kernels.chain on CPU tensors (its plain version, decode_chunk_ref)
  against JAX's decode_chunk_impl on the same seeded granules, on each of
  K1's four inputs: int16 (decode_chunk_packed_impl), int8
  (decode_chunk_packed8_impl), a GranuleBatch (decode_chunk_impl) and the
  fused wire, stereo and mono (decode_chunk_fused_(mono_)batch_impl).
  PCM ISO full (RMS < 0.289 LSB, max <= 2) over each stream's valid rows;
  the state within 2e-6 of its scale (test_stage_parity.py's IMDCT bound).
  The granules are torch_synthetic's at global gains 140-149, about full
  scale: at the default gains (up to ~10^4 x full scale) float32 rounding
  alone moves samples by tens of LSB (test_torch_granule.py).
- The wrapper's checks: dtypes, shapes and devices are refused; T = 0
  gives the state back; a CPU call launches nothing.
- The halo: the plain chain run block by block, as the kernel splits a
  chunk (granules t0 .. t1-1 of a block recomputed from t0-2, with the
  incoming state only where a block's slice starts at 0), equals the
  whole chunk bit for bit; a halo of one granule does not.
"""

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

FULL_RMS, FULL_MAXDIFF = 0.289, 2  # ISO/IEC 11172-4 full compliance
STATE_REL = 2e-6  # test_stage_parity.py: IMDCT, relative to the scale
GAINS = (140, 150)  # about full scale


def _state(s_dim: int, seed: int):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
            (rng.standard_normal((s_dim, 2, 16, 64)) * 0.05).astype(np.float32))


def _chunk(seed: int, s_dim: int, t_dim: int, valid, lines: int = 512, mono: bool = False):
    """Seeded granules as every input: (int16 arrays, int8 arrays, fused
    rows), all holding the same granules (tail past `lines` zero; channel 1
    zero on a mono wire)."""
    sp, sd = syn.random_chunk(seed, s_dim, t_dim, np.asarray(valid), gain_range=GAINS)
    tail, head, side = syn.to_packed8(sp, sd)
    tail = tail.reshape(s_dim, t_dim, 2, 512).copy()
    tail[..., lines:] = 0
    head = head.reshape(s_dim, t_dim, 2, 64).copy()
    if mono:
        tail[:, :, 1] = 0
        head[:, :, 1] = 0
    p8 = (tail.reshape(s_dim, t_dim, 1024), head.reshape(s_dim, t_dim, 128), side)
    build = W.build_fused_chunk_mono if mono else W.build_fused_chunk
    return syn.from_packed8(*p8), p8, build(*p8, lines)


INPUTS = ["int16", "int8", "granule_batch", "fused", "fused_mono"]


@pytest.mark.parametrize("label", INPUTS)
def test_chain_matches_jax_decode_chunk(label):
    s_dim, t_dim, lines = 3, 23, 301
    valid = np.array([t_dim, 13, 0], np.int32)
    mono = label == "fused_mono"
    p16, p8, buf = _chunk(17, s_dim, t_dim, valid, lines, mono)
    store, fifo = _state(s_dim, 18)
    j_state = JG.DecodeState(jnp.asarray(store), jnp.asarray(fifo))
    jv = jnp.asarray(valid)
    if label == "int16":
        j_pcm, j_st = JG.decode_chunk_packed_batch(*map(jnp.asarray, p16), j_state, jv)
        packed, kw = tuple(map(torch.from_numpy, p16)), {}
    elif label == "int8":
        j_pcm, j_st = JG.decode_chunk_packed8_batch(*map(jnp.asarray, p8), j_state, jv)
        packed, kw = tuple(map(torch.from_numpy, p8)), {}
    elif label == "granule_batch":
        jb = jax.vmap(JG.batch_from_packed)(*map(jnp.asarray, p16))
        j_pcm, j_st = JG.decode_chunk_batch(jb, j_state, jv)
        packed = P.GranuleBatch(*(f.contiguous() for f in P.batch_from_packed(
            *map(torch.from_numpy, p16))))
        kw = {}
    else:
        decode = JG.decode_chunk_fused_mono_batch_impl if mono else JG.decode_chunk_fused_batch_impl
        j_pcm, j_st = decode(jnp.asarray(buf), j_state, jv, t=t_dim, tail_lines=lines)
        packed, kw = torch.from_numpy(buf), {"t": t_dim, "tail_lines": lines, "mono": mono}
    K.reset_launch_counts()
    pcm, st = K.chain(packed, P.state_from_numpy(store, fifo, "cpu"),
                      torch.from_numpy(valid), **kw)
    assert K.chain.launches == 0 and not any(K.all_counts().values())  # CPU: plain
    j_pcm = np.asarray(j_pcm).astype(np.int64)
    got = pcm.numpy().astype(np.int64)
    assert got.shape == j_pcm.shape == (s_dim, t_dim * 576, 2)
    for s in range(s_dim):
        n = valid[s] * 576
        if n:
            d = (got[s, :n] - j_pcm[s, :n]).astype(np.float64)
            assert np.sqrt((d ** 2).mean()) < FULL_RMS and np.abs(d).max() <= FULL_MAXDIFF
    for ref, mine in zip((j_st.store, j_st.v_fifo), P.state_to_numpy(st)):
        ref = np.asarray(ref)
        assert np.abs(mine - ref).max() <= STATE_REL * np.abs(ref).max()
    # a stream with no valid granule keeps its state bit for bit
    np.testing.assert_array_equal(st.store[2].numpy(), store[2])
    np.testing.assert_array_equal(st.v_fifo[2].numpy(), fifo[2])


@pytest.mark.parametrize("label", INPUTS)
def test_chain_of_no_granules_gives_the_state_back(label):
    s_dim, lines = 2, 301
    p16, p8, buf = _chunk(3, s_dim, 0, np.zeros(s_dim, np.int32), lines,
                          label == "fused_mono")
    store, fifo = _state(s_dim, 4)
    state = P.state_from_numpy(store, fifo, "cpu")
    packed = {"int16": tuple(map(torch.from_numpy, p16)),
              "int8": tuple(map(torch.from_numpy, p8)),
              "granule_batch": P.GranuleBatch(*(f.contiguous() for f in P.batch_from_packed(
                  *map(torch.from_numpy, p16))))}.get(label, torch.from_numpy(buf))
    kw = {"t": 0, "tail_lines": lines, "mono": label == "fused_mono"} \
        if label.startswith("fused") else {}
    K.reset_launch_counts()
    pcm, st = K.chain(packed, state, torch.zeros(s_dim, dtype=torch.int32), **kw)
    assert pcm.shape == (s_dim, 0, 2) and K.chain.launches == 0
    for got, given in zip(st, state):
        assert torch.equal(got, given) and got.data_ptr() != given.data_ptr()


def test_chain_refuses_bad_inputs():
    s_dim, t_dim = 2, 5
    p16, _, buf = _chunk(5, s_dim, t_dim, [5, 3])
    packed = tuple(map(torch.from_numpy, p16))
    state = P.state_from_numpy(*_state(s_dim, 6), "cpu")
    valid = torch.tensor([5, 3], dtype=torch.int32)
    K.chain(packed, state, valid)  # the right arguments go through
    with pytest.raises(TypeError):
        K.chain(packed, P.DecodeState(state.store.double(), state.v_fifo), valid)
    with pytest.raises(TypeError):
        K.chain(packed, state, valid.long())
    with pytest.raises(TypeError):
        K.chain((packed[0].int(), packed[1]), state, valid)
    with pytest.raises(ValueError):
        K.chain(packed, state, valid[:1])
    with pytest.raises(ValueError):
        K.chain(packed, P.DecodeState(state.store[:1], state.v_fifo[:1]), valid)
    with pytest.raises(ValueError):
        K.chain(packed, state, valid, out=torch.empty((s_dim, t_dim * 576 + 2, 2),
                                                      dtype=torch.int16))
    with pytest.raises(ValueError):
        K.chain(packed + packed, state, valid)
    with pytest.raises(ValueError):  # wire rows without their description
        K.chain(torch.from_numpy(buf), state, valid)
    with pytest.raises(ValueError):  # a wire of another width
        K.chain(torch.from_numpy(buf), state, valid, t=t_dim, tail_lines=300)
    with pytest.raises(ValueError):  # another device than the inputs'
        K.chain(packed, P.DecodeState(state.store.to("meta"), state.v_fifo), valid)
    with pytest.raises(ValueError):  # no kernel and no plain version there
        K.chain(tuple(a.to("meta") for a in packed),
                P.DecodeState(*(a.to("meta") for a in state)), valid.to("meta"))


# -- the halo ----------------------------------------------------------------------


def _blockwise(batch: P.GranuleBatch, state: P.DecodeState, valid, g: int, halo: int):
    """The plain chain as the kernel splits a chunk: a block per run of g
    granules t0 .. t1-1, each decoding the slice [max(0, t0 - halo), t1) on
    its own, with the incoming state where the slice starts at 0 and a zero
    state elsewhere; the block's own granules kept, the halo's dropped. The
    state comes from the block holding granule valid-1 (the t0 = 0 block's
    when valid is 0)."""
    s_dim, t_dim = batch.spectra.shape[:2]
    pcm = torch.empty((s_dim, t_dim * 576, 2), dtype=torch.int16)
    store, fifo = state.store.clone(), state.v_fifo.clone()
    zero = P.init_state(s_dim, "cpu")
    for t0 in range(0, t_dim, g):
        t1, a = min(t0 + g, t_dim), max(0, t0 - halo)
        part = P.GranuleBatch(*(f[:, a:t1] for f in batch))
        v = (valid - a).clamp(0, t1 - a).to(torch.int32)
        out, st = P.decode_chunk_ref(part, state if a == 0 else zero, v)
        pcm[:, t0 * 576:t1 * 576] = out[:, (t0 - a) * 576:]
        mine = (valid > t0) & (valid <= t1) | ((valid == 0) & (t0 == 0))
        store[mine], fifo[mine] = st.store[mine], st.v_fifo[mine]
    return pcm, P.DecodeState(store, fifo)


def _halo_case(valid_kind: str):
    s_dim, t_dim = 3, 29
    valid = {"0": [0, 0, 0], "13": [13, 13, 13], "T": [t_dim, t_dim, t_dim]}[valid_kind]
    p16, _, _ = _chunk(23, s_dim, t_dim, [t_dim] * s_dim)
    batch = P.batch_from_packed(*map(torch.from_numpy, p16))
    rng = np.random.default_rng(24)
    state = P.state_from_numpy(
        (rng.standard_normal((s_dim, 2, 32, 18)) * 0.05).astype(np.float32),
        (rng.standard_normal((s_dim, 2, 16, 64)) * 0.3).astype(np.float32), "cpu")
    return batch, state, torch.tensor(valid, dtype=torch.int32)


@pytest.mark.parametrize("valid_kind", ["0", "13", "T"])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_halo_of_two_granules_gives_the_whole_chunk(g, valid_kind):
    """Bit for bit: no output of the CPU's plain chain depends on where a
    chunk is cut, its matrix products included."""
    batch, state, valid = _halo_case(valid_kind)
    whole, st = P.decode_chunk_ref(batch, state, valid)
    pcm, st_b = _blockwise(batch, state, valid, g, halo=2)
    assert torch.equal(pcm, whole)
    assert torch.equal(st_b.store, st.store) and torch.equal(st_b.v_fifo, st.v_fifo)


@pytest.mark.parametrize("g", [1, 4])
def test_halo_of_one_granule_fails(g):
    """The negative control: with one granule before a run, that granule's
    x18 overlaps a zero store, and the run's first 15 v rows are wrong."""
    batch, state, valid = _halo_case("T")
    whole, _ = P.decode_chunk_ref(batch, state, valid)
    pcm, _ = _blockwise(batch, state, valid, g, halo=1)
    rows = whole.shape[1] // 576
    bad = [t for t in range(rows) if not torch.equal(pcm[:, t * 576:(t + 1) * 576],
                                                     whole[:, t * 576:(t + 1) * 576])]
    assert bad and set(bad) <= set(range(g, rows, g))  # the runs' first granules
