"""Streams for a cell, made from the seed: a pool of frame runs per bitrate,
then clips or tracks composed of runs drawn from it.

Every seed gives the same sizes (clip and track lengths, bitrate counts per
batch); the seed changes the content and the order. Each stream carries the
work the chain does on it (roofline.py's operations and bytes), counted
from the fields the generator wrote.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import roofline
from . import mp3gen

BYTES_PER_FRAME_PCM = mp3gen.SAMPLES_PER_FRAME * 4  # s16le stereo


@dataclass
class Run:
    data: bytes
    starts: np.ndarray  # frame offsets [frames + 1]
    ops: np.ndarray  # chain operations per frame
    nbytes: np.ndarray  # chain bytes per frame


@dataclass
class Stream:
    data: bytes
    bitrate: int
    frames: int
    ops: float
    nbytes: float
    starts: list  # frame offsets

    @property
    def seconds(self) -> float:
        return self.frames * mp3gen.SAMPLES_PER_FRAME / mp3gen.SAMPLE_RATE

    @property
    def pcm_bytes(self) -> int:
        return self.frames * BYTES_PER_FRAME_PCM


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 63 - 1), *tags])


def _frame_work(gcs, n_frames, ms_of_frame):
    q = np.stack([g["q"] for g in gcs]).reshape(n_frames * 2, 2, 576)
    kind = np.array([g["kind"] for g in gcs]).reshape(n_frames * 2, 2)
    short = np.isin(kind, (mp3gen.SHORT, mp3gen.MIXED))
    mixed = kind == mp3gen.MIXED
    ms = np.repeat(ms_of_frame, 2)
    ops = roofline.granule_ops(q, short, mixed, ms).reshape(n_frames, 4).sum(1)
    bits = np.array([g["part23"] for g in gcs]).reshape(n_frames, 4)
    nbytes = roofline.granule_bytes(bits).sum(1)
    return ops.astype(np.float64), nbytes


def make_pool(cfg: dict, rng: np.random.Generator, bitrates) -> dict[int, list[Run]]:
    """bitrate -> runs, cfg["pool"] runs of cfg["pool"] frames each."""
    pool = {}
    n_runs = cfg["pool"]["runs_per_bitrate"]
    run_frames = cfg["pool"]["frames_per_run"]
    for br in bitrates:
        data, starts, gcs = mp3gen.make_run_fields(
            rng, br, n_runs * run_frames, run_frames=run_frames,
            lowpass_hz=cfg["lowpass_hz"][str(br)], short_share=cfg["short_share"],
            mixed_share=cfg["mixed_share"], ms_share=cfg["ms_share"],
            loudness_rms=cfg["loudness_rms"])
        n = n_runs * run_frames
        ms = np.array([data[s + 3] >> 4 & 2 == 2 for s in starts[:-1]])
        ops, nbytes = _frame_work(gcs, n, ms)
        runs = []
        for r in range(n_runs):
            a, b = r * run_frames, (r + 1) * run_frames
            s = starts[a:b + 1]
            runs.append(Run(data[s[0]:s[-1]], s - s[0], ops[a:b], nbytes[a:b]))
        pool[br] = runs
    return pool


def compose(rng: np.random.Generator, runs: list[Run], bitrate: int,
            n_frames: int) -> Stream:
    """A stream of n_frames frames: runs drawn from the pool, the last cut."""
    parts, ops, nbytes, starts, have = [], 0.0, 0.0, [], 0
    pos = 0
    while have < n_frames:
        run = runs[rng.integers(len(runs))]
        take = min(len(run.ops), n_frames - have)
        parts.append(run.data[:run.starts[take]])
        starts += [pos + int(x) for x in run.starts[:take]]
        pos += int(run.starts[take])
        ops += float(run.ops[:take].sum())
        nbytes += float(run.nbytes[:take].sum())
        have += take
    return Stream(b"".join(parts), bitrate, n_frames, ops, nbytes, starts)


def frames_for(seconds: float) -> int:
    return int(np.ceil(seconds * mp3gen.SAMPLE_RATE / mp3gen.SAMPLES_PER_FRAME))


def bitrate_counts(mix: dict, n: int) -> dict[int, int]:
    """Clips per bitrate in a batch of n: the mix's shares, largest
    remainders rounded up, the same for every seed."""
    shares = {int(k): v * n for k, v in mix.items()}
    counts = {k: int(np.floor(v)) for k, v in shares.items()}
    rest = n - sum(counts.values())
    for k in sorted(shares, key=lambda k: (counts[k] - shares[k], -k))[:rest]:
        counts[k] += 1
    return counts


def clip_batches(cfg: dict, wl: dict, seed: int) -> list[list[Stream]]:
    """The catalogue's clips, in batches of the workload's size: each batch
    holds the mix's count of each bitrate, in an order drawn from the seed."""
    rng = rng_for(seed, 1)
    mix = cfg["bitrate_mix"]
    pool = make_pool(cfg, rng, sorted(int(k) for k in mix))
    n = wl["batch_clips"]
    frames = frames_for(cfg["clip_seconds"])
    batches = []
    for _ in range(cfg["catalogue_clips"] // n):
        rates = [br for br, c in bitrate_counts(mix, n).items() for _ in range(c)]
        rng.shuffle(rates)
        batches.append([compose(rng, pool[br], br, frames) for br in rates])
    return batches


def tracks(cfg: dict, seed: int) -> list[Stream]:
    """The player's tracks."""
    rng = rng_for(seed, 2)
    br = cfg["bitrate_kbps"]
    pool = make_pool(cfg, rng, [br])
    frames = frames_for(cfg["track_seconds"])
    return [compose(rng, pool[br], br, frames) for _ in range(cfg["tracks"])]
