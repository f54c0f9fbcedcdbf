"""decode_corpus_fast parses its next segment ahead, on the CPU.

The fused path starts the parse of segment s+1 on a worker (a native
thread of its own, or the n_threads pool) before it packs and ships
segment s, into a second pool of parser rows. These tests hold that
overlap to the serial results: the PCM and granules byte-identical to the
port's serial fused=False path and ISO compliant against JAX's
decode_corpus_fast under every option that runs it; the worker's rows
byte-identical to the serial chunk parse; the counter
gomp3.corpus.prefetched; a parse's error (an int8 overflow, a hard error)
met in a segment parsed ahead, raised or rerun as the serial parse did;
no worker left running after an exception; and calls and a Decoder's
prefetch side by side in one process."""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import go_mp3_tpu.parallel.corpus as JC  # noqa: E402
import util_synth as U  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from go_mp3_tpu_torch import Decoder, decode_corpus_fast, spans  # noqa: E402
from go_mp3_tpu_torch.consts import HEAD_WIDTH, SIDE8_WIDTH, SP8_TAIL_WIDTH  # noqa: E402
from go_mp3_tpu_torch.native import lib as native  # noqa: E402
from go_mp3_tpu_torch.parallel import corpus as C  # noqa: E402
from go_mp3_tpu_torch.reference import FULL_MAXDIFF, FULL_RMS, index_stream, iso_metrics  # noqa: E402

CONF = Path(__file__).resolve().parent.parent / "conformance"
CHUNK_T = 16
BUCKETS = (64, 192, 448, 512)


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


def _corrupt(data: bytes, frame: int) -> bytes:
    """`data` with frame `frame`'s bitrate index set to 0 (free format): a
    valid sync, then the parser's hard "free bitrate" error."""
    starts, _, _ = index_stream(data)
    bad = bytearray(data)
    bad[int(starts[frame]) + 2] &= 0x0F
    return bytes(bad)


@pytest.fixture(scope="module")
def lanes():
    """Caller order, mono and stereo lanes of 48 to 168 granules (3 to 11
    chunks of 16): the escape lanes start at stereo frames (its frames
    8-11), so mono_split holds."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes()
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes()
    return [_rotate(lowrate * 3, 1), _rotate(escape * 4, 8), _rotate(escape * 7, 22),
            _rotate(lowrate * 5, 43), _rotate(escape * 2, 9)]


@pytest.fixture(scope="module")
def serial(lanes):
    """The serial path: the three-array interface, one chunk parsed, then
    shipped, then the next."""
    return decode_corpus_fast(lanes, chunk_t=CHUNK_T, fused=False, device="cpu")


@pytest.fixture(scope="module")
def jax_pcm(lanes):
    return JC.decode_corpus_fast(lanes, chunk_t=CHUNK_T).pcm


@pytest.fixture
def traced():
    spans.reset()
    yield lambda: profile(activities=[ProfilerActivity.CPU])
    spans.reset()


OPTIONS = [
    {},
    {"n_threads": 2},
    {"n_threads": 3},
    {"drain": 4, "tail_buckets": BUCKETS},
    {"drain": 4, "tail_buckets": BUCKETS, "n_threads": 3},
    {"mono_split": False},
    {"fetch": False},
]


@pytest.mark.parametrize("opts", OPTIONS, ids=lambda o: ",".join(
    f"{k}={v}" for k, v in o.items()) or "defaults")
def test_pcm_is_the_serial_pcm(lanes, serial, jax_pcm, opts, traced):
    """Every option: the serial path's PCM and granules byte for byte, ISO
    compliant against JAX; one segment in k chunks a call but the first
    parsed ahead (gomp3.corpus.prefetched); the phases and widths as the
    n_threads = 1 run has them."""
    with traced():
        got = decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu", **opts)
    counts = spans.totals()["counts"]
    if opts.get("fetch", True):
        res, pcm = got, got.pcm
    else:
        (dev, valids), res = got, got.stats
        pcm = [b"".join(dev[c, s, : valids[c, s] * 576].numpy().tobytes()
                        for c in range(len(valids))) for s in range(len(lanes))]
    assert pcm == serial.pcm and res.granules == serial.granules
    assert set(res.phase_seconds) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    for a, b in zip(pcm, jax_pcm):
        rms, maxdiff = iso_metrics(a, b)
        assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF, (rms, maxdiff)
    chunks = len(res.chunk_widths)
    assert chunks == 11  # ceil(168 / 16)
    k = opts.get("drain") or 1
    assert counts["gomp3.corpus.prefetched"] == -(-chunks // k) - 1
    if "n_threads" in opts:
        one = decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu",
                                 **{**opts, "n_threads": 1})
        assert (res.chunk_widths, res.wire_bytes) == (one.chunk_widths, one.wire_bytes)


@pytest.mark.parametrize("k", [1, 3, 12])
def test_worker_rows_are_the_serial_parse(lanes, k):
    """ParseWorker.start_many: k chunks of every stream into a [k, S, T, ..]
    pool, byte for byte as k serial BatchParser.parse_chunk_into calls fill
    them, stopping at the first chunk with no granule (the valids past it
    0), segment after segment to the end."""
    n = len(lanes)

    def pool():
        return (np.full((k, n, CHUNK_T, SP8_TAIL_WIDTH), 7, np.int8),
                np.full((k, n, CHUNK_T, HEAD_WIDTH), 7, np.int16),
                np.full((k, n, CHUNK_T, SIDE8_WIDTH), 7, np.uint8),
                np.full((k, n), 7, np.int32))

    ahead, serial = native.BatchParser(lanes), native.BatchParser(lanes)
    worker = native.ParseWorker()
    try:
        for _ in range(12):
            got, want = pool(), pool()
            worker.start_many(ahead, *got)
            n_chunks, seconds, err = worker.join_many()
            assert err is None and seconds >= 0
            want[3][:] = 0
            stop = k
            for c in range(k):
                if serial.parse_chunk_into(*(a[c] for a in want)) == 0:
                    stop = c
                    break
            assert n_chunks == stop
            for a, b in zip(got, want):  # the chunks past the stop untouched in both
                assert np.array_equal(a, b)
            if stop < k:
                break
        else:
            pytest.fail("the lanes never ended")
    finally:
        ahead.close()
        serial.close()


def test_int8_overflow_in_a_segment_parsed_ahead_reruns_on_int16(traced):
    """The tails overflow int8 first in chunk 1, which the worker parsed
    while the caller shipped chunk 0: the call reruns on the int16
    interface once, with the serial path's PCM, compliant against JAX."""
    data = b"".join(U.silent_frame() for _ in range(6)) + U.tail_escape_frame() * 2
    bp = native.BatchParser([data])
    rows = (np.zeros((1, 8, SP8_TAIL_WIDTH), np.int8), np.zeros((1, 8, HEAD_WIDTH), np.int16),
            np.zeros((1, 8, SIDE8_WIDTH), np.uint8), np.zeros(1, np.int32))
    try:
        assert bp.parse_chunk_into(*rows) == 8  # chunk 0 fits int8
        with pytest.raises(OverflowError):
            bp.parse_chunk_into(*rows)
    finally:
        bp.close()
    with traced():
        got = decode_corpus_fast([data], chunk_t=8, device="cpu")
    assert spans.totals()["counts"]["gomp3.corpus.reruns"] == 1
    want = decode_corpus_fast([data], chunk_t=8, fused=False, device="cpu")
    assert got.pcm == want.pcm and got.granules == want.granules == 16
    rms, maxdiff = iso_metrics(got.pcm[0], JC.decode_corpus_fast([data], chunk_t=8).pcm[0])
    assert rms < FULL_RMS and maxdiff <= FULL_MAXDIFF


def _serial_error(streams, t):
    """The error the serial chunk loop meets first: (type, message)."""
    bp = native.BatchParser(streams)
    rows = (np.zeros((len(streams), t, SP8_TAIL_WIDTH), np.int8),
            np.zeros((len(streams), t, HEAD_WIDTH), np.int16),
            np.zeros((len(streams), t, SIDE8_WIDTH), np.uint8),
            np.zeros(len(streams), np.int32))
    try:
        while bp.parse_chunk_into(*rows):
            pass
    except (ValueError, OverflowError) as e:
        return type(e), str(e)
    finally:
        bp.close()
    pytest.fail("no parse error")


@pytest.mark.parametrize("opts", [{}, {"n_threads": 3}, {"drain": 4},
                                  {"drain": 4, "n_threads": 3}],
                         ids=["defaults", "threads3", "drain4", "drain4,threads3"])
def test_hard_error_in_a_segment_parsed_ahead(opts):
    """Lane 3 breaks in chunk 5 and lane 0 in chunk 6 (of 16 granules,
    8 frames): the call raises the serial parse's error, naming lane 3,
    whichever lane block or worker met its error first."""
    escape = _rotate((CONF / "synthetic_escape.mp3").read_bytes() * 6, 8)
    streams = [_corrupt(escape, 49), escape, escape, _corrupt(escape, 41), escape]
    kind, message = _serial_error(streams, CHUNK_T)
    assert kind is ValueError and "stream 3" in message
    with pytest.raises(kind) as got:
        decode_corpus_fast(streams, chunk_t=CHUNK_T, device="cpu", **opts)
    assert str(got.value) == message


def _native_threads() -> int:
    return len(os.listdir("/proc/self/task"))


@pytest.mark.skipif(not Path("/proc/self/task").is_dir(), reason="counts threads in /proc")
def test_pack_error_joins_the_parse_in_flight(lanes, monkeypatch):
    """The pack of segment 1 raises while segment 2 parses on the worker:
    the parse is joined before the parsers are freed, and the worker's
    thread has ended once the call has raised."""
    decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")  # torch's own threads
    time.sleep(0.2)  # the warm-up call's worker thread ends
    before = _native_threads()
    workers, build = [], C.build_fused_chunk
    made = native.ParseWorker

    class Recorded(made):
        def __init__(self):
            super().__init__()
            workers.append(self)

    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 2:  # segment 1's pack, segment 2's parse in flight
            raise RuntimeError("pack failed")
        return build(*a, **kw)

    closed = []
    close = native.BatchParser.close

    def closing(self):
        closed.append([w._job for w in workers])  # no parse in flight when freed
        close(self)

    monkeypatch.setattr(C, "ParseWorker", Recorded)
    monkeypatch.setattr(C, "build_fused_chunk", failing)
    monkeypatch.setattr(native.BatchParser, "close", closing)
    with pytest.raises(RuntimeError, match="pack failed"):
        decode_corpus_fast(lanes, chunk_t=CHUNK_T, mono_split=False, device="cpu")
    assert len(workers) == 1 and closed and all(c == [None] for c in closed)
    del workers[:]
    deadline = time.monotonic() + 10
    while _native_threads() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert _native_threads() <= before


def test_calls_and_a_decoder_prefetch_side_by_side(lanes, serial):
    """Two corpus calls on two threads while a Decoder's prefetch is in
    flight on the main thread: each gives its serial result."""
    track = (CONF / "synthetic_escape.mp3").read_bytes() * 30
    want_track = Decoder(track, device="cpu").read_all()
    other = lanes[::-1]
    want_other = decode_corpus_fast(other, chunk_t=CHUNK_T, fused=False, device="cpu").pcm
    dec = Decoder(track, device="cpu")
    head = dec.read(4 * 576 * 4)  # its first readahead decoded, the next one's parse in flight
    results, errors = {}, []

    def call(name, streams, opts):
        try:
            results[name] = decode_corpus_fast(streams, chunk_t=CHUNK_T, device="cpu",
                                               **opts).pcm
        except Exception as e:  # noqa: BLE001 - reported by the assert below
            errors.append(e)

    threads = [threading.Thread(target=call, args=("a", lanes, {})),
               threading.Thread(target=call, args=("b", other, {"drain": 2}))]
    for th in threads:
        th.start()
    rest = dec.read_all()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    assert not errors
    assert head + rest == want_track
    assert results == {"a": serial.pcm, "b": want_other}


def _segments(lanes, n_threads: int = 1) -> list[tuple]:
    """Every segment of 2 chunks _SegmentParser parses ahead, to the end:
    (chunks, the pool's bytes) each."""
    groups = [C._Group(0, len(lanes), False, 0)]
    parser, out = C._SegmentParser(lanes, 2, CHUNK_T, groups, n_threads), []
    try:
        parser.start()
        while True:
            n_seg, rows = parser.join()
            out.append((n_seg, *(a.tobytes() for a in rows)))
            if n_seg < 2:
                return out
            parser.start()
    finally:
        parser.close()


def test_forked_child_parses_ahead_on_a_thread_of_its_own(lanes):
    """Fork copies no thread: a child forked after the parent's calls makes
    its own worker at its call and parses ahead on it, the parent's rows
    byte for byte."""
    want = _segments(lanes)
    assert len(want) == 6  # 11 chunks: 5 full segments, then one of 1
    U.in_child(lambda: _segments(lanes) == want)


@pytest.mark.parametrize("n_threads", [1, 3])
def test_parsers_on_more_threads_than_cores_keep_their_rows(lanes, n_threads):
    """More callers than cores, each handing its pools to and from its
    workers segment after segment, with the interpreter switching threads
    every 10 us: every caller's rows are the parse's rows byte for byte."""
    want = _segments(lanes, n_threads)
    got, interval = [], sys.getswitchinterval()

    def run():
        got.append(all(_segments(lanes, n_threads) == want for _ in range(3)))

    threads = [threading.Thread(target=run) for _ in range((os.cpu_count() or 1) + 2)]
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert got == [True] * len(threads)
