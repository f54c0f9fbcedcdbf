"""Playback: open the next track of the pool from its bytes and read it
whole, read after read, as a player's copy loop does.

Each read asks for the configuration's read_bytes. Workload keys:
check_reads (reads compared with the reference after the window; half of
them hold the first PCM of a decode call after the first, at a multiple of
the Decoder's readahead, where it has handed its state on from the call
before). A closed loop, one track an op.
"""

from __future__ import annotations

import torch

from ..check import Compared
from ..gen import traffic
from ..reference import decode as reference
from .player_seek import launches

GRANULE_BYTES = 576 * 4


def call_span(cfg: dict) -> int:
    """PCM bytes of one of the Decoder's readahead calls: readahead_frames
    frames of two granules (MPEG-1) or one (MPEG-2 and 2.5)."""
    per_frame = 2 if cfg["version"] == "MPEG-1" else 1
    return cfg["decoder"]["readahead_frames"] * per_frame * GRANULE_BYTES


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        from go_mp3_tpu_torch import Decoder

        self._open = lambda data: Decoder(
            data, backend=cfg["decoder"]["backend"],
            readahead_frames=cfg["decoder"]["readahead_frames"], device=device)
        self.wl, self.size = wl, cfg["read_bytes"]
        self.span = call_span(cfg)
        self.tracks = traffic.tracks(cfg, seed)
        self.rng = traffic.rng_for(seed, 3)
        self.n = 0
        self.audio_s = 0.0
        self.kept: list = []  # (track, read index, PCM, holds a hand-off)
        self.lengths: list = []
        self.failed = 0
        self.launches0 = 0

    def warm(self) -> None:
        dec = self._open(self.tracks[0].data)
        for _ in range(64):
            dec.read(self.size)
        self.launches0 = launches()

    def _picks(self, track):
        size = self.size
        n_reads = -(-track.pcm_bytes // size)
        # reads holding the first byte of a decode call after the first
        spans = [i for i in range(1, n_reads)
                 if -(-i * size // self.span) * self.span < min((i + 1) * size,
                                                                track.pcm_bytes)]
        return {int(self.rng.integers(n_reads)): False,
                int(spans[self.rng.integers(len(spans))]): True}

    def op(self) -> None:
        k = self.n % len(self.tracks)
        self.n += 1
        track = self.tracks[k]
        picks = self._picks(track)
        size, total, i = self.size, 0, 0
        with torch.profiler.record_function("open"):
            dec = self._open(track.data)
        while True:
            with torch.profiler.record_function("read"):
                pcm = dec.read(size)
            if not pcm:
                break
            if i in picks:
                self.kept.append((k, i, pcm, picks[i]))
            total += len(pcm)
            i += 1
        self.audio_s += total / (4 * traffic.mp3gen.SAMPLE_RATE)
        self.lengths.append((total, track.pcm_bytes))

    def attempted(self) -> int:
        return len(self.lengths)

    def end_to_end(self, window_s: float) -> dict:
        return {"stream_xrt": self.audio_s / window_s}

    def readings(self) -> dict:
        return {"audio_s": self.audio_s, "launches": launches() - self.launches0}

    def check(self, limits: dict) -> Compared:
        """Every track's length, then check_reads reads drawn from the
        seed, half of them across a hand-off."""
        out = Compared(limits)
        self.failed = sum(g != w for g, w in self.lengths)
        size, n = self.size, self.wl["check_reads"]
        draw = []
        for across in (True, False):
            idx = [j for j, r in enumerate(self.kept) if r[3] == across]
            m = min(len(idx), n // 2 if across else n - len(draw))
            draw += [idx[j] for j in self.rng.choice(len(idx), m, replace=False)]
        for j in sorted(draw):
            k, i, pcm, _ = self.kept[j]
            track = self.tracks[k]
            want = min(size, track.pcm_bytes - i * size)
            ref = reference.pcm_span(track.data, i * size, want, track.starts,
                                     traffic.BYTES_PER_FRAME_PCM)
            out.add(pcm, ref, f"track {k} read {i}")
        out.length_mismatches += self.failed
        self.kept = []
        return out
