"""The port's stream mesh (go_mp3_tpu_torch/parallel/mesh.py) and
decode_corpus_fast(mesh=...) against the unsharded port and against
go_mp3_tpu's mesh on its 8 virtual CPU devices (tests/conftest.py).

The port's CPU meshes repeat the one CPU device (the only way to run the
split without several cards). Sharded must equal unsharded bit for bit
(tolerance 0: the same plain chain on the same lanes). Against JAX's mesh
the PCM must be ISO fully compliant (RMS < 0.289 LSB, max difference <= 2
LSB) and the state within K3's 1e-6 of its scale (test_torch_granule.py's
STATE_REL); valid counts are integers and must be equal."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import go_mp3_tpu.ops.granule as JG  # noqa: E402
import go_mp3_tpu.parallel as JP  # noqa: E402
import go_mp3_tpu.parallel.corpus as JC  # noqa: E402
import go_mp3_tpu.parallel.mesh as JM  # noqa: E402
import go_mp3_tpu_torch.parallel as PP  # noqa: E402
import torch_synthetic as syn  # noqa: E402
from go_mp3_tpu_torch import decode_corpus_fast  # noqa: E402
from go_mp3_tpu_torch.ops import granule as P  # noqa: E402
from go_mp3_tpu_torch.ops import kernels as K  # noqa: E402
from go_mp3_tpu_torch.parallel import decode_corpus, parse_stream_granules  # noqa: E402
from go_mp3_tpu_torch.parallel import mesh as M  # noqa: E402
from go_mp3_tpu_torch.reference import (  # noqa: E402
    FULL_MAXDIFF,
    FULL_RMS,
    index_stream,
    iso_metrics,
)
from test_torch_granule import STATE_REL  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "conformance"
SIZES = [1, 2, 8]
S, T = 8, 12
CHUNK_T = 16
BUCKETS = (64, 192, 448, 512)


def _cpu_mesh(n: int) -> M.Mesh:
    return M.make_mesh(["cpu"] * n)


def _assert_compliant(a: bytes, b: bytes) -> None:
    rms, maxdiff = iso_metrics(a, b)
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)


# -- the sharded decoders --------------------------------------------------------


@pytest.fixture(scope="module")
def chunks():
    """Two seeded [S, T] chunks (every block class, stereo mode and band
    variant; ragged valids, lane 0 empty, lane 1 full) and a seeded state."""
    rng = np.random.default_rng(4)
    out = []
    for c in range(2):
        v = rng.integers(0, T + 1, S).astype(np.int32)
        v[0], v[1] = 0, T
        out.append((*syn.random_chunk(40 + c, S, T, v), v))
    state = ((rng.standard_normal((S, 2, 32, 18)) * 0.05).astype(np.float32),
             (rng.standard_normal((S, 2, 16, 64)) * 0.05).astype(np.float32))
    return out, state


def _inputs(route: str, sp, sd):
    if route == "batch":
        b = P.batch_from_packed(torch.from_numpy(sp), torch.from_numpy(sd))
        return P.GranuleBatch(*(f.contiguous() for f in b))
    return torch.from_numpy(sp), torch.from_numpy(sd)


@pytest.fixture(scope="module")
def unsharded(chunks):
    """kernels.decode_chunk on each route over both chunks: PCM per chunk
    and the final state."""
    out = {}
    data, state = chunks
    for route in ("batch", "int16"):
        st = P.state_from_numpy(*state, "cpu")
        pcms = []
        for sp, sd, v in data:
            pcm, st = K.decode_chunk(_inputs(route, sp, sd), st, torch.from_numpy(v))
            pcms.append(pcm)
        out[route] = (pcms, st)
    return out


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("route", ["batch", "int16"])
def test_sharded_decoder_equals_decode_chunk(chunks, unsharded, route, size):
    """make_sharded_decoder (GranuleBatch) and make_sharded_packed_decoder
    (the int16 arrays): bit-identical PCM and state, the state
    carried over two chunks (first a DecodeState of S streams, then the
    ShardedState the decoder returned)."""
    data, state = chunks
    mesh = _cpu_mesh(size)
    if route == "batch":
        fn = M.make_sharded_decoder(mesh)
    else:
        fn = M.make_sharded_packed_decoder(mesh)
    assert fn.mesh is mesh
    st = P.state_from_numpy(*state, "cpu")
    K.reset_launch_counts()
    for (sp, sd, v), want in zip(data, unsharded[route][0]):
        x = _inputs(route, sp, sd)
        args = (x, st, v) if route == "batch" else (*x, st, v)
        pcm, st = fn(*args)
        assert isinstance(pcm, M.ShardedPCM) and len(pcm) == size
        assert all(b.shape == (S // size, T * 576, 2) for b in pcm)
        assert torch.equal(pcm.cpu(), want)
        assert isinstance(st, M.ShardedState) and len(st) == size
    got, ref = st.cpu(), unsharded[route][1]
    assert torch.equal(got.store, ref.store) and torch.equal(got.v_fifo, ref.v_fifo)
    assert K.launch_counts()["synth"] == 0  # the CPU runs the plain chain


def test_sharded_decoder_matches_jax_mesh(chunks, unsharded):
    """The same two chunks through go_mp3_tpu's make_sharded_decoder on its
    8-device mesh, from a zero state: ISO full per lane and chunk, the
    state within 1e-6 of its scale."""
    data, _ = chunks
    fn = JM.make_sharded_decoder(JM.make_mesh())
    mine = M.make_sharded_decoder(_cpu_mesh(8))
    j_st, p_st = JM.init_states(S), M.init_states(S, "cpu")
    for sp, sd, v in data:
        jb = jax.vmap(JG.batch_from_packed)(jnp.asarray(sp), jnp.asarray(sd))
        j_pcm, j_st = fn(jb, j_st, jnp.asarray(v))
        p_pcm, p_st = mine(_inputs("batch", sp, sd), p_st, v)
        j_pcm, p_pcm = np.asarray(j_pcm), p_pcm.cpu().numpy()
        for s in range(S):
            n = v[s] * 576
            _assert_compliant(p_pcm[s, :n].tobytes(), j_pcm[s, :n].tobytes())
    for ref, got in zip((j_st.store, j_st.v_fifo), p_st.cpu()):
        ref = np.asarray(ref)
        assert np.abs(ref - got.numpy()).max() <= STATE_REL * np.abs(ref).max()


def test_sharded_decoder_checks_its_input(chunks):
    sp, sd, v = chunks[0][0]
    fn = M.make_sharded_decoder(_cpu_mesh(3))
    with pytest.raises(ValueError, match="split evenly"):
        fn(_inputs("batch", sp, sd), M.init_states(S, "cpu"), v)
    fn = M.make_sharded_decoder(_cpu_mesh(2))
    with pytest.raises(ValueError, match="streams"):
        fn(_inputs("batch", sp, sd), M.init_states(S - 2, "cpu"), v)
    with pytest.raises(ValueError, match="shard states"):
        fn(_inputs("batch", sp, sd), M.ShardedState([M.init_states(4, "cpu")]), v)
    with pytest.raises(ValueError, match="split evenly"):
        M.make_sharded_packed_decoder(_cpu_mesh(3))(
            *_inputs("int16", sp, sd), M.init_states(S, "cpu"), v)


# -- the mesh itself ---------------------------------------------------------------


def test_mesh_structure_and_exports():
    mesh = _cpu_mesh(2)
    assert mesh.size == 2 and mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.axis_names == (M.STREAM_AXIS,) and M.STREAM_AXIS == JM.STREAM_AXIS
    assert mesh.blocks(6) == [(torch.device("cpu"), 0, 3), (torch.device("cpu"), 3, 6)]
    assert mesh.holds("cpu") and not mesh.holds("cuda:1")
    with pytest.raises(AttributeError):
        mesh.devices = ()  # immutable
    with pytest.raises(ValueError):
        M.make_mesh([])
    assert M.init_states(3, "cpu").store.shape == (3, 2, 32, 18)
    for name in JP.__all__:
        assert name in PP.__all__ and hasattr(PP, name), name


def test_make_mesh_raises_without_cuda():
    """make_mesh() means every CUDA device; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; make_mesh() is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.make_mesh(["cuda:0"])


def test_entry_points_restore_the_device():
    """Every C entry point sets its device through DeviceGuard, which puts
    the caller's device back: torch.cuda.current_device() is the same
    after a launch on another card (checked on the card by chip_smoke.py
    phase 6). No source calls cudaSetDevice outside the guard."""
    csrc = ROOT / "go_mp3_tpu_torch" / "csrc"
    for src in csrc.glob("*.cu"):
        text = src.read_text()
        assert "cudaSetDevice" not in text, src.name
        entries = re.findall(r"^int (gomp3_\w+)\(int device", text, re.M)
        assert entries, src.name
        assert text.count("gomp3::DeviceGuard guard(device);") == len(entries), src.name
    guard = (csrc / "device_guard.cuh").read_text()
    assert "cudaGetDevice(&prev_)" in guard and "cudaSetDevice(prev_)" in guard


# -- decode_corpus_fast(mesh=...) ------------------------------------------------


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


@pytest.fixture(scope="module")
def lanes():
    """8 lanes, mono and stereo interleaved (the escape lanes start at its
    stereo frames 8-11, so mono_split holds)."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes() * 2
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes() * 2
    return [_rotate(lowrate, 1), _rotate(escape, 8), _rotate(escape, 9),
            _rotate(lowrate, 5), _rotate(escape, 10), _rotate(lowrate, 13),
            _rotate(lowrate, 20), _rotate(escape, 11)]


@pytest.fixture(scope="module")
def port_unsharded(lanes):
    return decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")


@pytest.fixture(scope="module")
def jax_mesh(lanes):
    """go_mp3_tpu's decode_corpus_fast on its 8-device mesh: fetched, and
    fetch=False's valids."""
    mesh = JM.make_mesh()
    fetched = JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T, mesh=mesh)
    _, valids = JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False, mesh=mesh)
    return fetched, np.asarray(valids)


OPTIONS = [
    {},
    {"drain": 2, "tail_buckets": BUCKETS},
    {"n_threads": 2},
    {"fused": False},
]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(
    f"{k}={v}" for k, v in o.items()) or "defaults")
def test_corpus_on_mesh(lanes, port_unsharded, jax_mesh, opts, size):
    got = decode_corpus_fast(lanes, chunk_t=CHUNK_T, mesh=_cpu_mesh(size), **opts)
    assert got.pcm == port_unsharded.pcm
    assert got.granules == port_unsharded.granules == jax_mesh[0].granules == 400
    assert set(got.phase_seconds) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    for a, b in zip(got.pcm, jax_mesh[0].pcm):
        _assert_compliant(a, b)
    if opts.get("fused", True):
        # every entry keeps its own stereo and mono groups
        per_entry = {1: 2, 2: 2, 8: 1}[size]
        assert all(len(w) == size * per_entry for w in got.chunk_widths)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three-array"])
def test_fetch_false_on_mesh(lanes, jax_mesh, size, fused):
    """One [C, S/n, T*576, 2] tensor per entry; concatenated along axis 1
    they are the unsharded array, and the valids are JAX's."""
    pcm, valids = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False,
                                     fused=fused, mesh=_cpu_mesh(size))
    ref, ref_valids = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False,
                                         fused=fused, device="cpu")
    assert isinstance(pcm, tuple) and len(pcm) == size
    assert all(p.shape == (ref.shape[0], S // size, *ref.shape[2:]) for p in pcm)
    assert torch.equal(torch.cat(pcm, dim=1), ref)
    assert np.array_equal(valids, ref_valids) and np.array_equal(valids, jax_mesh[1])


def test_indivisible_groups_keep_the_mono_split():
    """1 mono + 7 stereo lanes on a mesh of 8 (tests/test_parallel.py:
    326-343): JAX drops the mono split; each entry of the port keeps its
    own group, with the same bytes."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes() * 2
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes() * 2
    streams = [_rotate(lowrate, 3)] + [_rotate(escape, 8 + i % 4) for i in range(7)]
    ref = decode_corpus_fast(streams, chunk_t=CHUNK_T, mono_split=False, device="cpu")
    for size, n_groups in ((2, 3), (8, 8)):  # the mono lane's group stays
        got = decode_corpus_fast(streams, chunk_t=CHUNK_T, mesh=_cpu_mesh(size))
        assert got.pcm == ref.pcm and got.granules == ref.granules
        assert all(len(w) == n_groups for w in got.chunk_widths)
    want = JC.decode_corpus_fast(streams, chunk_t=CHUNK_T, mesh=JM.make_mesh())
    for a, b in zip(got.pcm, want.pcm):
        _assert_compliant(a, b)


def test_mesh_argument_checks(lanes):
    with pytest.raises(ValueError, match="split evenly"):
        decode_corpus_fast(lanes[:7], chunk_t=CHUNK_T, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="not in the mesh"):
        decode_corpus_fast(lanes, chunk_t=CHUNK_T, mesh=_cpu_mesh(2), device="cuda:0")
    got = decode_corpus_fast(lanes[:2], chunk_t=CHUNK_T, mesh=_cpu_mesh(2), device="cpu")
    assert got.granules > 0
    assert decode_corpus_fast([], mesh=_cpu_mesh(2)).pcm == []


def test_mono_split_mismatch_reruns_on_mesh():
    """A lane whose first frame is mono turns stereo: the whole corpus
    reruns unsplit, on the mesh too."""
    import util_synth as U

    tricky = U.escape_heavy_frame(
        n_pairs=8, linbit_value=500, global_gain=148
    ) + b"".join(U.silent_frame(mode=0) for _ in range(6))
    plain = b"".join(U.silent_frame(mode=0) for _ in range(8))
    streams = [plain, tricky, plain, tricky]
    ref = decode_corpus_fast(streams, chunk_t=8, mono_split=False, device="cpu")
    got = decode_corpus_fast(streams, chunk_t=8, mesh=_cpu_mesh(2))
    assert got.pcm == ref.pcm
    assert all(len(w) == 2 for w in got.chunk_widths)  # one group per entry


@pytest.mark.parametrize("size", [2, 8])
def test_decode_corpus_with_a_sharded_decoder(lanes, size):
    """decode_corpus(decode_fn=make_sharded_decoder(mesh)), as
    tests/test_parallel.py:34-43 runs it: the unsharded bytes."""
    streams = [parse_stream_granules(d, limit=40) for d in lanes]
    streams = [s[: 17 + 3 * i] for i, s in enumerate(streams)]  # ragged
    base = decode_corpus(streams, chunk_t=CHUNK_T, device="cpu")
    mesh = _cpu_mesh(size)
    got = decode_corpus(streams, chunk_t=CHUNK_T,
                        decode_fn=M.make_sharded_decoder(mesh), device="cpu")
    assert got.pcm == base.pcm and got.granules == base.granules
    with pytest.raises(ValueError, match="not in the mesh"):
        decode_corpus(streams, chunk_t=CHUNK_T,
                      decode_fn=M.make_sharded_decoder(mesh), device="cuda:0")
