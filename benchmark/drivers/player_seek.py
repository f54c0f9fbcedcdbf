"""Scrubbing: one user seeks a track of the pool and reads the first PCM.

The read after the seek asks for the configuration's read_bytes. Workload
keys: seek ("uniform": a track drawn uniformly from the pool, a time
uniform in it), check_ops (ops compared with the reference after the
window). Every track's Decoder is opened in set-up. An op's latency runs from seek_to_time(t) until the read
returned; a closed loop.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..check import Compared
from ..gen import traffic
from ..reference import decode as reference


def launches() -> int:
    from go_mp3_tpu_torch.ops import kernels

    return sum(kernels.launch_counts().values())


class Driver:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        from go_mp3_tpu_torch import Decoder

        if wl["seek"] != "uniform":
            raise ValueError(f"seek distribution {wl['seek']!r} is not known")
        self.wl, self.size = wl, cfg["read_bytes"]
        self.tracks = traffic.tracks(cfg, seed)
        dec = cfg["decoder"]
        self.decoders = [Decoder(t.data, backend=dec["backend"],
                                 readahead_frames=dec["readahead_frames"], device=device)
                         for t in self.tracks]
        self.rng = traffic.rng_for(seed, 3)
        self.latency_ms: list[float] = []
        self.seek_ms: list[float] = []
        self.done: list = []  # (track, byte offset, PCM)
        self.failed = 0
        self.launches0 = 0

    def _pick(self):
        k = int(self.rng.integers(len(self.tracks)))
        return k, float(self.rng.random()) * self.tracks[k].seconds

    def warm(self) -> None:
        for _ in range(8):
            k, t = self._pick()
            self.decoders[k].seek_to_time(t)
            self.decoders[k].read(self.size)
        self.launches0 = launches()

    def op(self) -> None:
        k, t = self._pick()
        dec = self.decoders[k]
        t0 = time.perf_counter()
        with torch.profiler.record_function("seek_to_time"):
            dec.seek_to_time(t)
        t1 = time.perf_counter()
        with torch.profiler.record_function("read"):
            pcm = dec.read(self.size)
        t2 = time.perf_counter()
        self.seek_ms.append((t1 - t0) * 1e3)
        self.latency_ms.append((t2 - t0) * 1e3)
        self.done.append((k, int(t * traffic.mp3gen.SAMPLE_RATE * 4) & ~3, pcm))

    def attempted(self) -> int:
        return len(self.done)

    def end_to_end(self, window_s: float) -> dict:
        return {"seek_p95_ms": float(np.percentile(self.latency_ms, 95))}

    def readings(self) -> dict:
        return {"seek_call_ms": list(self.seek_ms), "ops": len(self.done),
                "launches": launches() - self.launches0}

    def check(self, limits: dict) -> Compared:
        """check_ops ops drawn from the seed: the PCM read after the seek
        against the linear decode's at that byte offset."""
        out = Compared(limits)
        self.decoders = None
        starts = [s.starts for s in self.tracks]
        draw = self.rng.choice(len(self.done), min(self.wl["check_ops"], len(self.done)),
                               replace=False)
        for i in sorted(draw):
            k, pos, pcm = self.done[i]
            track = self.tracks[k]
            want = min(self.size, track.pcm_bytes - pos)
            ref = reference.pcm_span(track.data, pos, want, starts[k],
                                     traffic.BYTES_PER_FRAME_PCM)
            out.add(pcm, ref, f"op {i}: track {k} byte {pos}")
        self.done = []
        return out
