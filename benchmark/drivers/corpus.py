"""Batch ingest: call after call of decode_corpus_fast on batches of clips.

Workload keys: batch_clips (clips a call), fetch (PCM back in host memory,
or kept on the card), check_clips (clips compared whole with the reference
after the window), check_span_frames (the PCM of so many frames, at an
offset drawn from the seed, compared in every clip of one call drawn from
the seed). A closed loop: the next call starts when the last returned.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostuse
from ..check import Compared
from ..gen import traffic
from ..reference import decode as reference

SPAN = "decode_corpus_fast"
BPF = traffic.BYTES_PER_FRAME_PCM


def lane_offsets(rng: np.random.Generator, batch: list, nbytes: int) -> list[int]:
    """A byte offset in each clip of a batch, at a sample, for a span of
    nbytes."""
    return [int(rng.integers((s.pcm_bytes - nbytes) // 4 + 1)) * 4 for s in batch]


def device_spans(pcm: torch.Tensor, valids: np.ndarray, offsets: list[int],
                 nbytes: int) -> list:
    """fetch=False's PCM [C, S, T*576, 2] at [offset, offset + nbytes) of
    each lane, gathered on the card in one call (the copy to the host waits
    for the check) -> one int16 [n, 2] tensor a lane."""
    where, counts = [], []
    for j, off in enumerate(offsets):
        cum = np.concatenate([[0], np.cumsum(valids[:, j].astype(np.int64))]) * 576
        idx = off // 4 + np.arange(nbytes // 4)
        idx = idx[idx < cum[-1]]  # past the lane's PCM: a short answer
        c = np.searchsorted(cum, idx, side="right") - 1
        where.append(np.stack([c, np.full_like(c, j), idx - cum[c]]))
        counts.append(len(idx))
    ix = torch.from_numpy(np.concatenate(where, 1)).to(pcm.device)
    return list(torch.split(pcm[ix[0], ix[1], ix[2]], counts))


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        from go_mp3_tpu_torch.parallel import decode_corpus_fast

        self._decode = decode_corpus_fast
        self.wl, self.device = wl, device
        self.fetch = bool(wl["fetch"])
        self.batches = traffic.clip_batches(cfg, wl, seed)
        self.rng = traffic.rng_for(seed, 3)
        self.calls = 0
        self.failed = 0
        self.audio_s = 0.0
        self.phases: dict[str, float] = {}
        self.per_call: list = []  # each call's phase_seconds and host use
        self.ops = 0.0
        self.nbytes = 0.0
        self.kept: list = []  # (stream, program's PCM) of one drawn clip a call
        self.lanes = None  # (call, batch, offsets, each lane's span) of one drawn call
        self.span_bytes = wl["check_span_frames"] * BPF
        self.lengths: list = []  # (got, want) of every clip

    def _call(self, batch):
        return self._decode([s.data for s in batch], fetch=self.fetch, device=self.device)

    def warm(self) -> None:
        """One call on each batch: the window's first calls then find the
        host's PCM buffers faulted in, as the later ones do."""
        for batch in self.batches:
            self._call(batch)

    def op(self) -> None:
        batch = self.batches[self.calls % len(self.batches)]
        pick = int(self.rng.integers(len(batch)))
        self.calls += 1
        use = hostuse.now()
        with torch.profiler.record_function(SPAN):
            res = self._call(batch)
        use = hostuse.since(use)
        stats = res if self.fetch else res.stats
        for k, v in stats.phase_seconds.items():
            self.phases[k] = self.phases.get(k, 0.0) + v
        self.per_call.append({**stats.phase_seconds, **use})
        self.audio_s += sum(s.seconds for s in batch)
        self.ops += sum(s.ops for s in batch)
        self.nbytes += sum(s.nbytes for s in batch)
        if self.fetch:
            got = [len(p) for p in res.pcm]
            self.kept.append((batch[pick], res.pcm[pick]))
        else:
            pcm, valids = res
            got = [int(v) * 576 * 4 for v in valids.sum(0)]
            self.kept.append((batch[pick], (pcm[:, pick].clone(), valids[:, pick].copy())))
        if self.rng.random() * self.calls < 1:  # every call as likely to be the one kept
            offsets = lane_offsets(self.rng, batch, self.span_bytes)
            if self.fetch:
                spans = [p[o:o + self.span_bytes] for p, o in zip(res.pcm, offsets)]
            else:
                spans = device_spans(pcm, valids, offsets, self.span_bytes)
            self.lanes = (self.calls - 1, batch, offsets, spans)
        self.lengths += [(g, s.pcm_bytes) for g, s in zip(got, batch)]

    def attempted(self) -> int:
        return len(self.lengths)

    def end_to_end(self, window_s: float) -> dict:
        return {"corpus_xrt": self.audio_s / window_s}

    def readings(self) -> dict:
        """What the per-layer metric readers read."""
        return {"phase_seconds": dict(self.phases), "audio_s": self.audio_s,
                "chain_ops": self.ops, "chain_bytes": self.nbytes,
                "per_call": list(self.per_call)}

    def check(self, limits: dict) -> Compared:
        """Every clip's length; check_clips clips drawn from the seed, each
        decoded whole by the reference; and a span of every clip of the
        call drawn, against the reference's decode of it."""
        out = Compared(limits)
        self.failed = sum(g != w for g, w in self.lengths)
        self.batches = None
        draw = self.rng.choice(len(self.kept), min(self.wl["check_clips"], len(self.kept)),
                               replace=False)
        for i in sorted(draw):
            stream, got = self.kept[i]
            if not self.fetch:
                pcm, valids = got
                got = b"".join(pcm[c, : int(v) * 576].cpu().numpy().tobytes()
                               for c, v in enumerate(valids))
            out.add(got, reference.decode(stream.data), f"call {i}")
        self.kept = []
        call, batch, offsets, spans = self.lanes
        for j, (stream, off, got) in enumerate(zip(batch, offsets, spans)):
            if not self.fetch:
                got = got.cpu().numpy().tobytes()
            want = reference.pcm_span(stream.data, off, self.span_bytes, stream.starts, BPF)
            out.add(got, want, f"call {call} clip {j} byte {off}")
        self.lanes = None
        out.length_mismatches += self.failed
        return out
