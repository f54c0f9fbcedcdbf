"""The smoke corpus: rotated lanes built from the repo's two bitstreams.

48 lanes of conformance/synthetic_escape.mp3 x128 (MPEG-1 44.1 kHz, 40.1 s
each) and 16 of conformance/synthetic_lowrate.mp3 x110 (MPEG-2 22.05 kHz
mono, 74.7 s each): 193,216 granules, 3,121.32 s of audio, the size of
bench.py's corpus, whose reference fixtures are absent from this checkout.
"""

from __future__ import annotations

from pathlib import Path

from ..reference import index_stream

BUNDLE = Path(__file__).resolve().parents[2] / "conformance"
ESCAPE = BUNDLE / "synthetic_escape.mp3"
LOWRATE = BUNDLE / "synthetic_lowrate.mp3"
N_STEREO, N_MONO = 48, 16  # lane groups of the smoke corpus


def corpus_lanes(n_escape: int = N_STEREO, n_lowrate: int = N_MONO,
                 escape_times: int = 128, lowrate_times: int = 110) -> list[bytes]:
    """Rotated lanes, each starting at a different frame (as bench.py
    builds its corpus). The escape stream mixes mono and stereo frames;
    its lanes start at the next stereo frame, so that they are the stereo
    lane group of mono_split (their mono frames ride the stereo wire) and
    the lowrate lanes the mono group."""

    def rotated(data: bytes, n: int, step: int, stereo_first: bool) -> list[bytes]:
        starts, _, _ = index_stream(data)
        out = []
        for s in range(n):
            i = (1 + step * s) % len(starts)
            if stereo_first:  # header byte 3, bits 7-6: channel mode, 3 = mono
                while data[int(starts[i]) + 3] >> 6 == 3:
                    i = (i + 1) % len(starts)
            off = int(starts[i])
            out.append(data[off:] + data[:off])
        return out

    escape = ESCAPE.read_bytes() * escape_times
    lowrate = LOWRATE.read_bytes() * lowrate_times
    return (rotated(escape, n_escape, 29, stereo_first=True)
            + rotated(lowrate, n_lowrate, 43, stereo_first=False))
