"""Seeded synthetic granules covering every block class, stereo mode and band
variant, in the packed layouts the C++ parser writes. JAX-free: chip_smoke.py
uses it on the GPU machine, and the tests/test_torch_*.py files here.

Real streams rarely exercise intensity stereo or mixed blocks, so the
kernel checks draw random frames the way tests/test_synth_parity.py's
random_frame does: same fields, same ranges, the same 150 CASES, but from a
numpy Generator and straight into numpy arrays, without the bitstream
classes. test_torch_granule.py holds the packing against the JAX pipeline's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from go_mp3_tpu_torch.ops import tables as T

# the parser's layouts (go_mp3_tpu/consts.py)
SAMPLES_PER_GR = 576
HEAD_LINES = 64
SIDE_WIDTH = 144
SIDE8_WIDTH = 168

# (lsf, sfreq, mode, mode_ext, (win_switch, block_type, mixed))
CASES = [
    (lsf, sfreq, mode, mode_ext, block_spec)
    for lsf, sfreq in ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2))
    for mode, mode_ext in ((0, 0), (1, 1), (1, 2), (1, 3), (3, 0))
    for block_spec in ((0, 0, 0), (1, 1, 0), (1, 3, 0), (1, 2, 0), (1, 2, 1))
]


class Frame(NamedTuple):
    """One frame's header fields and, indexed [granule, channel, ...], the
    side-info and main-data fields the DSP reads. Unused slots are 0."""

    lsf: int
    sfreq: int
    mode: int
    mode_ext: int
    block_spec: tuple
    global_gain: np.ndarray  # [2, 2]
    scalefac_scale: np.ndarray  # [2, 2]
    preflag: np.ndarray  # [2, 2]
    count1: np.ndarray  # [2, 2]
    subblock_gain: np.ndarray  # [2, 2, 3]
    scalefac_l: np.ndarray  # [2, 2, 22]
    scalefac_s: np.ndarray  # [2, 2, 13, 3]
    spectra: np.ndarray  # [2, 2, 576], before the short-block reorder

    @property
    def granules(self) -> int:
        return 1 if self.lsf else 2

    @property
    def channels(self) -> int:
        return 1 if self.mode == 3 else 2


_FIELD_SHAPES = ((2, 2),) * 4 + ((2, 2, 3), (2, 2, 22), (2, 2, 13, 3), (2, 2, SAMPLES_PER_GR))


# global_gain's range (upper bound exclusive), test_synth_parity's
GAIN_RANGE = (140, 206)


def random_frame(rng: np.random.Generator, lsf, sfreq, mode, mode_ext, block_spec,
                 gain_range=GAIN_RANGE) -> Frame:
    """A coherent frame with white-noise spectra at realistic energy and a
    few large values below line 64. gain_range: global_gain's range; the
    default reaches ~10^4 x full scale, (140, 150) stays about full
    scale."""
    f = Frame(lsf, sfreq, mode, mode_ext, tuple(block_spec),
              *(np.zeros(s, np.int32) for s in _FIELD_SHAPES))
    for gr in range(f.granules):
        for ch in range(f.channels):
            f.global_gain[gr, ch] = rng.integers(*gain_range)
            f.scalefac_scale[gr, ch] = rng.integers(0, 2)
            if lsf == 0:
                f.preflag[gr, ch] = rng.integers(0, 2)
            f.subblock_gain[gr, ch] = rng.integers(0, 8, 3)
            count1 = int(rng.choice([0, 96, 240, 396, 576]))
            f.count1[gr, ch] = count1
            f.scalefac_l[gr, ch] = rng.integers(0, 12, 22)
            f.scalefac_s[gr, ch] = rng.integers(0, 8, (13, 3))
            spec = rng.integers(-30, 30, SAMPLES_PER_GR)
            spec[rng.integers(0, 64, 4)] = rng.choice([-2000, -300, 300, 2000], 4)
            spec[count1:] = 0
            f.spectra[gr, ch] = spec
    return f


def pack_frames(frames: list[Frame]) -> tuple[np.ndarray, np.ndarray]:
    """Frames -> (spectra2 int16 [n, 1152], side int16 [n, 144]), the
    layout of NativeParser.parse_packed_into: post-reorder spectra and the
    side words of native/lib.py (META_* slots, then the scalefactors)."""
    spectra, sides = [], []
    for f in frames:
        nch = f.channels
        variant = f.lsf * 3 + f.sfreq
        ms = f.mode == 1 and bool(f.mode_ext & 2)
        intensity = f.mode == 1 and bool(f.mode_ext & 1)
        cls = T.block_class(*f.block_spec)
        for gr in range(f.granules):
            spec = f.spectra[gr].astype(np.int16)
            w = np.zeros(SIDE_WIDTH, np.int16)
            w[0] = variant
            w[1] = int(ms) | int(intensity) << 1 | int(nch == 1) << 2
            w[2] = f.count1[gr, nch - 1]
            for ch in range(nch):
                if cls == T.CLASS_SHORT:
                    spec[ch] = spec[ch][T.REORDER_PERM_SHORT[variant]]
                elif cls == T.CLASS_MIXED:
                    spec[ch] = spec[ch][T.REORDER_PERM_MIXED[variant]]
                w[4 + ch] = f.global_gain[gr, ch]
                w[6 + ch] = f.scalefac_scale[gr, ch]
                w[8 + ch] = f.preflag[gr, ch]
                w[10 + ch] = f.block_spec[1]
                w[12 + ch] = cls
                w[14 + 3 * ch : 17 + 3 * ch] = f.subblock_gain[gr, ch]
                w[20 + ch] = f.count1[gr, ch]
            w[22:66] = f.scalefac_l[gr].reshape(-1)
            w[66:144] = f.scalefac_s[gr].reshape(-1)
            spectra.append(spec.reshape(-1))
            sides.append(w)
    return np.stack(spectra), np.stack(sides)


def to_packed8(
    spectra2: np.ndarray, side: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Int16 interface [.., 1152] + [.., 144] -> the int8 interface (tail8
    [.., 1024] i8, head16 [.., 128] i16, side8 [.., 168] u8). Tail lines
    beyond int8 are clipped: this makes a test input, it is not the
    parser's overflow path."""
    lead = spectra2.shape[:-1]
    sp = spectra2.reshape(*lead, 2, SAMPLES_PER_GR)
    head16 = np.ascontiguousarray(sp[..., :HEAD_LINES]).reshape(*lead, 2 * HEAD_LINES)
    tail8 = (
        np.clip(sp[..., HEAD_LINES:], -127, 127)
        .astype(np.int8)
        .reshape(*lead, 2 * (SAMPLES_PER_GR - HEAD_LINES))
    )
    side8 = np.zeros((*lead, SIDE8_WIDTH), np.uint8)
    meta = side[..., :22].astype(np.uint16)
    side8[..., 0:44:2] = meta & 0xFF
    side8[..., 1:44:2] = meta >> 8
    side8[..., 44:166] = side[..., 22:144].astype(np.uint8)
    return tail8, head16, side8


def from_packed8(
    tail8: np.ndarray, head16: np.ndarray, side8: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The int8 interface -> the int16 interface holding the same granules
    (to_packed8's inverse where no tail line was clipped)."""
    lead = tail8.shape[:-1]
    spectra = np.concatenate(
        [head16.reshape(*lead, 2, HEAD_LINES),
         tail8.reshape(*lead, 2, SAMPLES_PER_GR - HEAD_LINES).astype(np.int16)],
        axis=-1,
    ).reshape(*lead, 2 * SAMPLES_PER_GR)
    meta = side8[..., 0:44:2].astype(np.uint16) | side8[..., 1:44:2].astype(np.uint16) << 8
    side = np.concatenate([meta.view(np.int16), side8[..., 44:166].astype(np.int16)], axis=-1)
    return spectra, side


def random_chunk(
    seed: int, n_streams: int, t: int, valid: np.ndarray, gain_range=GAIN_RANGE
) -> tuple[np.ndarray, np.ndarray]:
    """[S, T] packed int16 chunk holding valid[s] granules in lane s. The
    frames take the CASES in turn across lanes (each case appears once
    every 150 frames); rows at or past valid[s] are zero, as the parser
    pads them. gain_range: random_frame's."""
    rng = np.random.default_rng(seed)
    spectra = np.zeros((n_streams, t, 2 * SAMPLES_PER_GR), np.int16)
    side = np.zeros((n_streams, t, SIDE_WIDTH), np.int16)
    k = 0
    for s in range(n_streams):
        frames, n = [], 0
        while n < valid[s]:
            f = random_frame(rng, *CASES[k % len(CASES)], gain_range=gain_range)
            k += 1
            frames.append(f)
            n += f.granules
        if frames:
            sp, sd = pack_frames(frames)
            spectra[s, : valid[s]] = sp[: valid[s]]
            side[s, : valid[s]] = sd[: valid[s]]
    return spectra, side
