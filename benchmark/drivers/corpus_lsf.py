"""Batch ingest of MPEG-2 LSF mono speech: drivers/corpus.py's closed loop of
decode_corpus_fast calls, on tracks from the LSF writer (gen/mp3gen_lsf.py).

Workload keys as drivers/corpus.py's. A frame is one granule here: 576
samples, 576 x 4 bytes of s16le stereo PCM, the unit of the spans checked
(check_span_frames) and of their reference decode.
"""

from __future__ import annotations

from ..gen import mp3gen_lsf, traffic
from ..reference import decode as reference
from . import corpus

BPF = mp3gen_lsf.BYTES_PER_FRAME_PCM


class Driver(corpus.Driver):
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        """corpus.Driver's state, with the batches from the LSF writer
        (corpus.Driver draws MPEG-1 clips from gen/traffic.py)."""
        from go_mp3_tpu_torch.parallel import decode_corpus_fast

        self._decode = decode_corpus_fast
        self.wl, self.device = wl, device
        self.fetch = bool(wl["fetch"])
        self.batches = mp3gen_lsf.track_batches(cfg, wl, seed)
        self.rng = traffic.rng_for(seed, 3)
        self.calls = 0
        self.failed = 0
        self.audio_s = 0.0
        self.phases: dict[str, float] = {}
        self.per_call: list = []
        self.ops = 0.0
        self.nbytes = 0.0
        self.kept: list = []
        self.lanes = None
        self.span_bytes = wl["check_span_frames"] * BPF
        self.lengths: list = []

    def check(self, limits: dict):
        """corpus.Driver's check, with the spans of the call drawn decoded
        by the reference at this format's frame: the clips compared whole
        and every length by corpus.Driver.check, then each span here."""
        call, batch, offsets, spans = self.lanes
        self.lanes = (call, [], [], [])
        out = super().check(limits)
        for j, (stream, off, got) in enumerate(zip(batch, offsets, spans)):
            if not self.fetch:
                got = got.cpu().numpy().tobytes()
            want = reference.pcm_span(stream.data, off, self.span_bytes, stream.starts, BPF)
            out.add(got, want, f"call {call} clip {j} byte {off}")
        return out
