"""The benchmark's frozen copies held against their originals in the port
at commit 6b659fa: each copied file against the sha256 of its original
there (in its header), and while the port's file is still that original,
the copy's behaviour against it (the Huffman tables, the frame parser, the
golden DSP, the trace summary); and the reference's batched DSP against the
golden. A later change to the port leaves the copies as they are."""

import hashlib
import io
import re

import numpy as np
import pytest

from benchmark import tracing
from benchmark.gen import huffman_tables, mp3gen
from benchmark.reference import decode as reference
from benchmark.reference import reference_dsp
from benchmark.reference.dsp import StreamDSP, granules_of

KW = dict(lowpass_hz=20500, short_share=0.1, mixed_share=0.04, ms_share=0.8,
          loudness_rms=0.012)


@pytest.fixture(scope="module")
def stream():
    rng = np.random.default_rng(5)
    return b"".join(r[0] for r in mp3gen.make_runs(rng, 320, 3, 20, **KW))


COPIES = {"gen/huffman_tables.py": "bitstream/huffman_tables.py",
          "reference/consts.py": "consts.py",
          **{f"reference/{m}.py": f"bitstream/{m}.py" for m in
             ("bits", "frameheader", "sideinfo", "maindata", "huffman", "parser", "source")},
          **{f"reference/{m}.py": f"golden/{m}.py" for m in
             ("reference_dsp", "tables", "synth_window_data")}}
HEADER = re.compile(r"# Frozen copy of go_mp3_tpu_torch/(\S+) at commit 6b659fa"
                    r"(\.|, its imports made local\.)\n"
                    r"# sha256 of the original( without its relative imports)?: ([0-9a-f]{64})\n")


def _sha(text: str) -> str:
    """sha256 of a source's lines, relative imports left out."""
    lines = [line for line in text.splitlines() if not line.startswith("from .")]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


def _header(copy: str):
    from benchmark.run import HERE

    text = (HERE / copy).read_text()
    m = HEADER.match(text)
    assert m, f"{copy} has no frozen-copy header"
    return m, text[m.end():]


def _unchanged(*copies: str) -> None:
    """Skip a comparison with the port's files once one has moved on from
    the original the copy was made of: the hash still holds the copy."""
    from benchmark.run import ROOT

    for copy in copies:
        m, _ = _header(copy)
        if _sha((ROOT / "go_mp3_tpu_torch" / COPIES[copy]).read_text()) != m.group(4):
            pytest.skip(f"go_mp3_tpu_torch/{COPIES[copy]} has changed since 6b659fa")


def test_huffman_tables_equal_the_ports():
    from go_mp3_tpu_torch.bitstream import huffman_tables as orig

    _unchanged("gen/huffman_tables.py")

    assert huffman_tables.TABLES == orig.TABLES


def test_parser_copy_reads_what_the_port_reads(stream):
    from go_mp3_tpu_torch.bitstream import Source as OSource
    from go_mp3_tpu_torch.bitstream.parser import FrameReader as OReader

    _unchanged(*(c for c, o in COPIES.items() if o.startswith("bitstream/")))
    ours = reference._frames(stream, 0, None)
    src, fr, theirs = OSource(io.BytesIO(stream)), OReader(), []
    while len(theirs) < len(ours):
        theirs.append(fr.read(src, src.pos))
    for a, b in zip(ours, theirs):
        assert a.header.word == b.header.word
        assert vars(a.side_info) == vars(b.side_info)
        for field in ("is_", "scalefac_l", "scalefac_s"):
            np.testing.assert_array_equal(getattr(a.main_data, field),
                                          getattr(b.main_data, field))


def test_golden_copy_equals_the_ports_golden(stream):
    from go_mp3_tpu_torch.golden import GoldenDecoder

    _unchanged(*(c for c, o in COPIES.items() if o.startswith("golden/")),
               "reference/consts.py")
    frames = reference._frames(stream, 0, None)
    a, b = reference_dsp.GoldenDecoder(), GoldenDecoder()
    for f in frames:
        assert a.decode_frame(f.header, f.side_info, f.main_data) == \
            b.decode_frame(f.header, f.side_info, f.main_data)


def test_batched_dsp_equals_the_golden(stream):
    frames = reference._frames(stream, 0, None)
    gold = reference_dsp.GoldenDecoder()
    want = np.frombuffer(b"".join(gold.decode_frame(f.header, f.side_info, f.main_data)
                                  for f in frames), "<i2").astype(int)
    dsp = StreamDSP()
    got = np.concatenate([dsp.decode(granules_of(frames[i:i + 7])).reshape(-1)
                          for i in range(0, len(frames), 7)]).astype(int)
    # float64 sums in another order may round across a float32 boundary
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 1e-4


def test_window_decode_equals_the_linear_decode(stream):
    whole = reference.decode(stream)
    starts = reference.frame_starts(stream)
    bpf = 1152 * 4
    for first in (0, 1, 3, 17, 41, 59):
        assert reference.decode_frames(stream, first, 2, starts) == \
            whole[first * bpf:(first + 2) * bpf]
    assert reference.pcm_span(stream, 12345 * 4, 32768, starts, bpf) == \
        whole[12345 * 4:12345 * 4 + 32768]


def _trace():
    """A synthetic trace: a window of 1,000 us holding two host spans, three
    device events (two of the chain kernel) and a projected span copy."""
    x = lambda name, ts, dur, cat, tid=1: {"ph": "X", "name": name, "ts": ts,
                                           "dur": dur, "cat": cat, "pid": 0, "tid": tid}
    return [x("W", 0, 1000, "user_annotation"),
            x("call", 10, 500, "user_annotation"), x("read", 600, 390, "cpu_op"),
            x("chain_kernel<3, 4>", 100, 50, "kernel"),
            x("chain_kernel_run1<0, 1>", 140, 30, "kernel"),
            x("Memcpy HtoD", 700, 100, "gpu_memcpy")]


def test_trace_copy_equals_the_ports_summary():
    from benchmark.run import ROOT
    from go_mp3_tpu_torch.tools import profile_decode as orig

    path, first, last, sha = tracing.ORIGINAL
    lines = (ROOT / path).read_text().splitlines()[first - 1:last]
    if hashlib.sha256("\n".join(lines).encode()).hexdigest() != sha:
        pytest.skip(f"{path}:{first}-{last} has changed since 6b659fa")
    events = _trace()
    for e in events:
        if e["name"] == "W":
            e["name"] = orig.WINDOW
    want = orig.summarize(events)
    got = tracing.summarize(events, window=orig.WINDOW)
    assert got == want


def test_trace_arithmetic():
    s = tracing.summarize(_trace(), window="W", n_gaps=10)
    assert s["window_us"] == 1000
    assert s["busy_us"] == 70 + 100  # [100, 170] and [700, 800]
    assert s["busy_share"] == pytest.approx(0.17)
    assert [g["us"] for g in s["gaps"]] == [530, 200, 100]
    assert [g["host_op"] for g in s["gaps"]] == ["call", "read", "call"]
    assert tracing.chain_device_us(s) == 80
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["Memcpy HtoD", 100e-6]
    assert b["idle_gaps"][0] == ["call", 530e-6]


def test_profile_events_leave_out_the_spans_on_the_device_timeline():
    class E:
        def __init__(self, name, dev, start, end, ann=False):
            self._v = (name, dev, start, end, ann)

        def name(self):
            return self._v[0]

        def device_type(self):
            return self._v[1]

        def start_ns(self):
            return self._v[2] * 1000

        def duration_ns(self):
            return (self._v[3] - self._v[2]) * 1000

        def is_user_annotation(self):
            return self._v[4]

        def start_thread_id(self):
            return 1

    events = [E("call", "DeviceType.CPU", 0, 100, True), E("[memory]", "DeviceType.CPU", 3, 3),
              E("call", "DeviceType.CUDA", 5, 95, True),
              E("chain_kernel<3, 4>", "DeviceType.CUDA", 10, 20),
              E("Memcpy DtoH (Device -> Pinned)", "DeviceType.CUDA", 30, 40)]
    prof = type("P", (), {})()
    prof.profiler = type("A", (), {})()
    prof.profiler.kineto_results = type("K", (), {"events": lambda self: events})()
    ev = tracing.profile_events(prof)
    assert [(e["name"], e["cat"], e["ts"], e["dur"]) for e in ev] == [
        ("call", "cpu_op", 0, 100), ("chain_kernel<3, 4>", "kernel", 10, 10),
        ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 30, 10)]


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copy_is_its_original_but_for_imports(copy):
    m, body = _header(copy)
    assert m.group(1) == COPIES[copy]
    assert (m.group(2) == ".") == copy.startswith("gen/")
    assert _sha(body) == m.group(4)


def test_trace_copy_names_its_original_at_6b659fa():
    path, first, last, sha = tracing.ORIGINAL
    assert (first, last) == (135, 222) and path.endswith("tools/profile_decode.py")
    assert f":{first}-{last}" in tracing.__doc__ and "6b659fa" in tracing.__doc__
