"""go_mp3_tpu_torch.spans: the port's spans and counters, on the CPU.

Off without a profiler (nothing entered, nothing counted); under
torch.profiler every span opened on the caller's thread is an event of the
trace (the corpus parse, timed on its worker, is recorded at the join and
is not), its totals add up
(own time plus nested time is its time, one thread at a time), the
corpus's host phases are the spans' own readings, the counters count the
chunks, decodes, warm-up frames and reruns, the corpus's counters are the
returned result's granules, slots, mono-wire granules and wire bytes, and the PCM
is the same with tracing on and off."""

import json
import math
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import util_synth as U  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.gen import mp3gen_lsf, traffic  # noqa: E402
from go_mp3_tpu_torch import Decoder, decode_corpus_fast, spans  # noqa: E402
from go_mp3_tpu_torch.reference import index_stream  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "conformance"
CHUNK_T = 64
CORPUS = ("gomp3.corpus.call", "gomp3.corpus.parse", "gomp3.corpus.pack",
          "gomp3.corpus.emit", "gomp3.corpus.wait", "gomp3.corpus.parse_wait")
OFF_THREAD = {"gomp3.corpus.parse"}  # timed on the worker, recorded at the join
DECODER = ("gomp3.decoder.open", "gomp3.decoder.seek", "gomp3.decoder.read",
           "gomp3.decoder.parse", "gomp3.decoder.h2d", "gomp3.decoder.launch",
           "gomp3.decoder.d2h", "gomp3.decoder.prefetch_wait")
INNER = DECODER[3:]


def _rotate(data: bytes, k: int) -> bytes:
    starts, _, _ = index_stream(data)
    off = int(starts[k % len(starts)])
    return data[off:] + data[:off]


@pytest.fixture(scope="module")
def lanes():
    """A stereo lane (the escape stream from its stereo frame 8, so the
    mono split holds) and two mono ones: no rerun."""
    escape = (CONF / "synthetic_escape.mp3").read_bytes() * 12
    lowrate = (CONF / "synthetic_lowrate.mp3").read_bytes() * 4
    return [_rotate(escape, 8), _rotate(lowrate, 1), _rotate(lowrate, 43)]


@pytest.fixture(scope="module")
def track():
    """A track as gomp3_player's (MPEG-1, 128 kbps joint stereo), 6 s."""
    cfg = json.loads((ROOT / "benchmark/configs/gomp3_player.json").read_text())
    cfg.update(tracks=1, track_seconds=6, pool={"runs_per_bitrate": 2, "frames_per_run": 8})
    return traffic.tracks(cfg, 2 ** 31 + 3)[0]


@pytest.fixture
def traced():
    """Totals cleared; a CPU profiler's window as a context manager."""
    spans.reset()

    def window():
        return profile(activities=[ProfilerActivity.CPU])

    yield window
    spans.reset()


def _decoder_ops(data: bytes) -> bytes:
    """An open, a seek and reads, as a player does: the PCM read."""
    dec = Decoder(data, device="cpu")
    out = dec.read(20000)
    dec.seek_to_time(dec.duration() / 2)
    return out + dec.read(40000) + dec.read(-1)


def test_off_enters_nothing_and_records_nothing(lanes, track, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a span was entered with no profiler running")

    monkeypatch.setattr(spans, "_Record", Refused)
    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    spans.reset()
    assert not spans.enabled()
    assert spans.span("gomp3.x") is spans.span("gomp3.y")  # one shared object
    decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")
    decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=False, device="cpu")
    _decoder_ops(track.data)
    assert spans.totals() == {"spans": {}, "counts": {}}


def test_trace_holds_every_span(lanes, track, traced):
    with traced() as prof:
        decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")
        _decoder_ops(track.data)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert set(CORPUS + DECODER) - OFF_THREAD <= names
    assert not OFF_THREAD & names
    assert set(spans.totals()["spans"]) == set(CORPUS + DECODER)


@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "ondevice"])
def test_corpus_counts_match_its_chunks(lanes, traced, fetch):
    with traced():
        res = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=fetch, device="cpu")
    stats = res if fetch else res.stats
    chunks = len(stats.chunk_widths)
    assert chunks == math.ceil(max(len(index_stream(d)[0]) * (2 if i == 0 else 1)
                                   for i, d in enumerate(lanes)) / CHUNK_T)
    got = {k: v["n"] for k, v in spans.totals()["spans"].items()}
    # a parse per chunk and the one that finds every lane ended, each
    # joined; with fetch, an emit per chunk and the final join, each emit
    # after a wait
    emits = chunks + 1 if fetch else 1
    assert got == {"gomp3.corpus.call": 1, "gomp3.corpus.parse": chunks + 1,
                   "gomp3.corpus.parse_wait": chunks + 1,
                   "gomp3.corpus.pack": chunks, "gomp3.corpus.emit": emits,
                   "gomp3.corpus.wait": chunks + 1 + (chunks if fetch else 0) + 1}
    mono = sum(len(index_stream(d)[0]) for d in lanes[1:])  # one granule an LSF frame
    assert spans.totals()["counts"] == {"gomp3.corpus.prefetched": chunks - 1,
                                        "gomp3.corpus.granules": stats.granules,
                                        "gomp3.corpus.slots": chunks * len(lanes) * CHUNK_T,
                                        "gomp3.corpus.mono_granules": mono,
                                        "gomp3.corpus.wire_bytes": stats.wire_bytes}


@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "ondevice"])
def test_corpus_phases_are_the_spans_readings(lanes, traced, fetch):
    with traced():
        res = decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=fetch, device="cpu")
    phases = (res if fetch else res.stats).phase_seconds
    assert set(phases) == {"parse", "pack", "h2d", "kernels", "d2h", "emit"}
    got = spans.totals()["spans"]
    for phase in ("parse", "pack", "emit"):
        assert phases[phase] == got[f"gomp3.corpus.{phase}"]["s"], phase


def test_corpus_call_is_its_own_time_and_its_children(lanes, traced):
    """The call's own time and the spans nested in it are the call's time;
    the parse, timed on its worker outside the call, is not nested in it
    (the caller's wait for it, gomp3.corpus.parse_wait, is)."""
    with traced():
        decode_corpus_fast(lanes, chunk_t=CHUNK_T, device="cpu")
    got = spans.totals()["spans"]
    call = got["gomp3.corpus.call"]
    inner = sum(got[n]["s"] for n in CORPUS[1:] if n not in OFF_THREAD)
    assert 0 < call["self_s"] < call["s"]
    assert call["self_s"] + inner == pytest.approx(call["s"], rel=1e-9, abs=1e-12)
    for name in CORPUS[1:]:  # leaves: all their time their own
        assert got[name]["self_s"] == got[name]["s"]


def test_decoder_roots_are_their_own_time_and_their_children(track, traced, monkeypatch):
    """The roots' own time and the spans nested in them are the roots'
    time. A prefetch's parse, timed on its native worker thread outside
    every root, adds to the parse span's totals (spans.record), not to a
    root."""
    off_thread, record = [], spans.record

    def recorded(name, seconds):
        off_thread.append((name, seconds))
        record(name, seconds)

    monkeypatch.setattr(spans, "record", recorded)
    with traced():
        _decoder_ops(track.data)
    got = spans.totals()["spans"]
    assert off_thread and {n for n, _ in off_thread} == {"gomp3.decoder.parse"}
    assert len(off_thread) < got["gomp3.decoder.parse"]["n"]  # the open's parse is the caller's
    roots = [got[n] for n in DECODER[:3]]
    inner = sum(got[n]["s"] for n in INNER) - sum(s for _, s in off_thread)
    assert sum(r["self_s"] for r in roots) + inner == pytest.approx(
        sum(r["s"] for r in roots), rel=1e-9, abs=1e-12)
    assert got["gomp3.decoder.open"]["n"] == got["gomp3.decoder.seek"]["n"] == 1


def test_decoder_counts_its_decodes(track, traced):
    """Read whole from the open: one decode per 128 granules, each
    copying its granules' rows rounded up to 4 (128 but for the last);
    every granule counted once; every decode but the open's served from a
    prefetch."""
    with traced():
        dec = Decoder(track.data, device="cpu")
        pcm = dec.read(-1)
    granules = len(pcm) // (576 * 4)
    assert granules == 2 * track.frames
    decodes = math.ceil(granules / 128)
    last = granules - 128 * (decodes - 1)
    got = spans.totals()
    for name in ("gomp3.decoder.h2d", "gomp3.decoder.launch", "gomp3.decoder.d2h"):
        assert got["spans"][name]["n"] == decodes
    assert got["counts"] == {"gomp3.decoder.granules": granules,
                             "gomp3.decoder.rows": 128 * (decodes - 1) + -(-last // 4) * 4,
                             "gomp3.decoder.prefetched": decodes - 1}


def test_seek_counts_warmup_frames_and_rows(track, traced):
    """On a 128 kbps MPEG-1 track (frames of 417-418 bytes) a seek past the
    fourth frame decodes 4 frames before its target, as _warmup_depth
    says; a seek and its read make one device decode, which copies its
    granules' rows rounded up to a multiple of 4 (at most 128)."""
    dec = Decoder(track.data, device="cpu")
    bpf = dec.bytes_per_frame()
    times = [0.0, 0.05, 1.0, 2.5, 4.9, dec.duration() * 0.7]
    ks, rows = [], []
    with traced():
        for t in times:
            dec.seek_to_time(t)
            ks.append(dec._warmup_depth((int(t * dec.sample_rate() * 4) & ~3) // bpf))
            before = spans.totals()["counts"]
            dec.read(32768)
            after = spans.totals()["counts"]
            assert after["gomp3.decoder.seek_folds"] == len(ks)
            granules = after["gomp3.decoder.granules"] - before.get("gomp3.decoder.granules", 0)
            rows.append(after["gomp3.decoder.rows"] - before.get("gomp3.decoder.rows", 0))
            assert rows[-1] == -(-granules // 4) * 4 <= 128
    assert ks[0] == 0 and ks[2:] == [4] * (len(times) - 2)
    got = spans.totals()
    assert got["counts"]["gomp3.decoder.warmup_frames"] == sum(ks)
    assert got["spans"]["gomp3.decoder.launch"]["n"] == len(times)
    assert got["counts"]["gomp3.decoder.rows"] == sum(rows) < 128 * len(times)
    assert got["spans"]["gomp3.decoder.seek"]["n"] == len(times)


@pytest.mark.parametrize("ops", ["whole_reads", "seek_reads"])
def test_prefetched_counts_readaheads_not_seeks(track, traced, ops):
    """gomp3.decoder.prefetched: tracks opened and read whole in 32 KiB
    reads, as player.read's ops, count every decode but each open's, and
    the caller joins once more a track, at the end of the audio
    (gomp3.decoder.prefetch_wait); seek_to_time then a 32 KiB read, as
    player.seek's ops on an open Decoder, count none and join nothing: a
    fold starts no prefetch, and the first seek drops the open's."""
    if ops == "whole_reads":
        with traced():
            for _ in range(2):
                dec = Decoder(track.data, device="cpu")
                while dec.read(32768):
                    pass
        decodes = 2 * math.ceil(2 * track.frames / 128)
        got = spans.totals()
        assert got["spans"]["gomp3.decoder.launch"]["n"] == decodes
        assert got["counts"]["gomp3.decoder.prefetched"] == decodes - 2
        assert got["spans"]["gomp3.decoder.prefetch_wait"]["n"] == decodes
        return
    dec = Decoder(track.data, device="cpu")
    times = np.random.default_rng(5).uniform(0, dec.duration(), 12)
    with traced():
        for t in times:
            dec.seek_to_time(float(t))
            dec.read(32768)
    got = spans.totals()
    assert got["spans"]["gomp3.decoder.launch"]["n"] == len(times)
    assert got["counts"]["gomp3.decoder.seek_folds"] == len(times)
    assert "gomp3.decoder.prefetched" not in got["counts"]
    assert "gomp3.decoder.prefetch_wait" not in got["spans"]


@pytest.mark.parametrize("case", ["mono_split_mismatch", "int16_overflow"])
def test_reruns_are_counted(traced, case):
    if case == "mono_split_mismatch":  # tests/test_torch_fused.py's stream
        tricky = U.escape_heavy_frame(n_pairs=8, linbit_value=500, global_gain=148) + \
            b"".join(U.silent_frame(mode=0) for _ in range(6))
        streams = [b"".join(U.silent_frame(mode=0) for _ in range(8)), tricky]
        chunk_t = 8
    else:
        streams, chunk_t = [U.tail_escape_frame() * 3], 16
    plain = decode_corpus_fast(streams, chunk_t=chunk_t, device="cpu")
    with traced():
        got = decode_corpus_fast(streams, chunk_t=chunk_t, device="cpu")
    assert got.pcm == plain.pcm and got.granules == plain.granules
    if case == "int16_overflow":  # decoded on the int16 interface: no wire
        assert got.granules == 6 and got.chunk_widths == []
        assert got.pcm[0] == Decoder(streams[0], device="cpu").read_all()
    else:  # one stereo group: a wire width a chunk
        assert all(len(w) == 1 for w in got.chunk_widths)
    # one rerun; the other counters only of the run whose result came back;
    # the first run stopped at its first segment, so only the rerun's fused
    # chunks but its first were parsed ahead (the int16 rerun parses serially)
    chunks = 1 if case == "int16_overflow" else len(got.chunk_widths)  # 6 granules of 16
    ahead = {} if case == "int16_overflow" else {"gomp3.corpus.prefetched": chunks - 1}
    assert spans.totals()["counts"] == {"gomp3.corpus.reruns": 1, **ahead,
                                        "gomp3.corpus.granules": got.granules,
                                        "gomp3.corpus.slots": chunks * len(streams) * chunk_t,
                                        "gomp3.corpus.mono_granules": 0,
                                        "gomp3.corpus.wire_bytes": got.wire_bytes}
    assert spans.totals()["spans"]["gomp3.corpus.call"]["n"] == 1


def _counter_batch(kind: str) -> list[bytes]:
    """A small batch of the benchmark's: fma_clips' MPEG-1 stereo clips, or
    speech_lsf's MPEG-2 mono tracks."""
    pool = {"runs_per_bitrate": 2, "frames_per_run": 8}
    if kind == "fma":
        cfg = json.loads((ROOT / "benchmark/configs/fma_clips.json").read_text())
        cfg.update(catalogue_clips=3, clip_seconds=2, pool=pool)
        batch = traffic.clip_batches(cfg, {"batch_clips": 3}, 2 ** 31 + 5)[0]
    else:
        cfg = json.loads((ROOT / "benchmark/configs/speech_lsf.json").read_text())
        cfg.update(catalogue_tracks=3, track_frames=90, pool=pool)
        batch = mp3gen_lsf.track_batches(cfg, {"batch_clips": 3}, 2 ** 31 + 5)[0]
    return [s.data for s in batch]


@pytest.mark.parametrize("kind", ["fma", "lsf"])
def test_corpus_counters_are_the_results(traced, kind, monkeypatch):
    """Off, the corpus counters record nothing; on, they are the result's
    granules and wire bytes, every granule of the mono batch on the mono
    wire and none of the stereo one."""
    streams = _counter_batch(kind)
    monkeypatch.setattr(spans, "_Record", None)  # off: no span is entered either
    off = decode_corpus_fast(streams, chunk_t=CHUNK_T, fetch=False, device="cpu")
    assert spans.totals() == {"spans": {}, "counts": {}}
    monkeypatch.undo()
    with traced():
        res = decode_corpus_fast(streams, chunk_t=CHUNK_T, fetch=False, device="cpu").stats
    assert res.granules == off.stats.granules > 0 and res.wire_bytes == off.stats.wire_bytes
    chunks = len(res.chunk_widths)
    assert spans.totals()["counts"] == {
        **({"gomp3.corpus.prefetched": chunks - 1} if chunks > 1 else {}),
        "gomp3.corpus.granules": res.granules,
        "gomp3.corpus.slots": chunks * len(streams) * CHUNK_T,
        "gomp3.corpus.mono_granules": res.granules if kind == "lsf" else 0,
        "gomp3.corpus.wire_bytes": res.wire_bytes}


def test_record_adds_a_span_timed_elsewhere(traced):
    """record(): off, nothing; on, one span of the seconds given, all its
    own time, and no part of the span open on this thread."""
    spans.record("gomp3.test.native", 0.25)
    assert spans.totals() == {"spans": {}, "counts": {}}
    with traced():
        with spans.span("gomp3.test.outer") as outer:
            spans.record("gomp3.test.native", 0.25)
            spans.record("gomp3.test.native", 0.5)
    got = spans.totals()["spans"]
    assert got["gomp3.test.native"] == {"n": 2, "s": 0.75, "self_s": 0.75}
    assert got["gomp3.test.outer"]["self_s"] == got["gomp3.test.outer"]["s"] == outer.seconds


def test_two_threads_do_not_nest_into_each_other(traced):
    """Thread a's outer span is open while thread b opens and closes its
    own spans: each outer span's own time leaves out only its own thread's
    inner span."""
    step = threading.Barrier(2, timeout=30)

    def work(tag, inner_s):
        with spans.span(f"gomp3.test.outer_{tag}"):
            step.wait()
            with spans.span(f"gomp3.test.inner_{tag}"):
                threading.Event().wait(inner_s)
            step.wait()

    with traced():
        threads = [threading.Thread(target=work, args=(t, s))
                   for t, s in (("a", 0.05), ("b", 0.01))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    got = spans.totals()["spans"]
    for tag in "ab":
        outer, inner = got[f"gomp3.test.outer_{tag}"], got[f"gomp3.test.inner_{tag}"]
        assert outer["self_s"] == pytest.approx(outer["s"] - inner["s"], abs=1e-12)
    assert got["gomp3.test.inner_a"]["s"] >= 0.05
    assert got["gomp3.test.outer_b"]["self_s"] >= 0.03  # waited for a's inner span


@pytest.mark.parametrize("fetch", [True, False], ids=["fetch", "ondevice"])
def test_corpus_pcm_same_traced(lanes, traced, fetch):
    def run():
        return decode_corpus_fast(lanes, chunk_t=CHUNK_T, fetch=fetch, device="cpu")

    plain = run()
    with traced():
        got = run()
    if fetch:
        assert got.pcm == plain.pcm and got.granules == plain.granules
    else:
        assert torch.equal(got[0], plain[0]) and (got[1] == plain[1]).all()


def test_decoder_pcm_same_traced(track, traced):
    plain = _decoder_ops(track.data)
    with traced():
        got = _decoder_ops(track.data)
    assert got == plain and len(plain) > 0
