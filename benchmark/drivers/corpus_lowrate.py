"""Batch ingest of a low-rate catalogue: drivers/corpus.py's closed loop of
decode_corpus_fast calls, on batches that mix three formats
(gen/mp3gen_rates.py: MPEG-1 at 44.1 and 32 kHz, MPEG-2 LSF at 24 kHz), so
that the lanes of a call are of unequal length.

Workload keys as drivers/corpus.py's, but the spans checked are counted in
granules (check_span_granules): 576 samples, 576 x 4 bytes of s16le stereo
PCM, the unit the three formats share. Each span is decoded by the
reference at its own stream's frame (two granules an MPEG-1 frame, one an
LSF frame).
"""

from __future__ import annotations

from ..gen import mp3gen_rates, traffic
from ..reference import decode as reference
from . import corpus

BPG = mp3gen_rates.BYTES_PER_GRANULE_PCM


class Driver(corpus.Driver):
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        """corpus.Driver's state, with the batches from the low-rate writer
        and spans of check_span_granules granules."""
        from go_mp3_tpu_torch.parallel import decode_corpus_fast

        self._decode = decode_corpus_fast
        self.wl, self.device = wl, device
        self.fetch = bool(wl["fetch"])
        self.batches = mp3gen_rates.clip_batches(cfg, wl, seed)
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
        self.span_bytes = wl["check_span_granules"] * BPG
        self.lengths: list = []

    def check(self, limits: dict):
        """corpus.Driver's check (every length, the clips compared whole),
        then each span of the call drawn, decoded by the reference at its
        stream's frame."""
        call, batch, offsets, spans = self.lanes
        self.lanes = (call, [], [], [])
        out = super().check(limits)
        for j, (stream, off, got) in enumerate(zip(batch, offsets, spans)):
            if not self.fetch:
                got = got.cpu().numpy().tobytes()
            want = reference.pcm_span(stream.data, off, self.span_bytes, stream.starts,
                                      stream.frame_pcm_bytes)
            out.add(got, want, f"call {call} clip {j} byte {off}")
        return out
