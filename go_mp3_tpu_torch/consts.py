"""Shared constants, enums and typed errors for the TPU-native MP3 framework.

Semantics match the reference decoder's constant layer
(go-mp3 internal/consts/consts.go:25-97) — these are ISO/IEC 11172-3
spec constants, re-declared here in Python form.
"""

from __future__ import annotations

import enum


class Version(enum.IntEnum):
    """MPEG version field of the frame header (2 bits at position 19-20)."""

    MPEG2_5 = 0
    RESERVED = 1
    MPEG2 = 2
    MPEG1 = 3


class Layer(enum.IntEnum):
    """MPEG layer field of the frame header (2 bits at position 17-18)."""

    RESERVED = 0
    LAYER3 = 1
    LAYER2 = 2
    LAYER1 = 3


class Mode(enum.IntEnum):
    """Channel mode field of the frame header (2 bits at position 6-7)."""

    STEREO = 0
    JOINT_STEREO = 1
    DUAL_CHANNEL = 2
    SINGLE_CHANNEL = 3


SAMPLES_PER_GR = 576
GRANULES_MPEG1 = 2
SAMPLING_FREQUENCY_RESERVED = 3

# Maximum bytes scanned for a sync word before giving up
# (ref: frameheader.go:263, matches ffmpeg/mpg123 defaults).
MAX_SYNC_SEARCH_BYTES = 64 * 1024


class MP3Error(Exception):
    """Base class for all framework errors."""


class UnexpectedEOFError(MP3Error):
    """Input ended in the middle of a structure (ref: consts.go:17-23)."""

    def __init__(self, at: str):
        super().__init__(f"mp3: unexpected EOF at {at}")
        self.at = at


class SyncSearchLimitError(MP3Error):
    """No valid frame header found within MAX_SYNC_SEARCH_BYTES
    (ref: frameheader.go:267-273)."""

    def __init__(self, bytes_searched: int):
        super().__init__(
            f"mp3: no valid frame header found within {bytes_searched} bytes"
        )
        self.bytes_searched = bytes_searched


class EOFError_(MP3Error):
    """Clean end-of-stream (the Python analogue of Go's io.EOF)."""


# Scalefactor band index tables, indexed [lsf][sfreq][long|short]
# (ISO 11172-3 Table B.8; ref layout consts.go:68-97).
# lsf: 0 = MPEG-1, 1 = MPEG-2. sfreq: header sampling-frequency index
# (0 -> 44.1kHz family, 1 -> 48kHz family, 2 -> 32kHz family).
SF_BAND_INDICES_LONG = 0
SF_BAND_INDICES_SHORT = 1

SF_BAND_INDICES = (
    (  # MPEG-1
        (
            (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 52, 62, 74, 90, 110, 134,
             162, 196, 238, 288, 342, 418, 576),
            (0, 4, 8, 12, 16, 22, 30, 40, 52, 66, 84, 106, 136, 192),
        ),
        (
            (0, 4, 8, 12, 16, 20, 24, 30, 36, 42, 50, 60, 72, 88, 106, 128,
             156, 190, 230, 276, 330, 384, 576),
            (0, 4, 8, 12, 16, 22, 28, 38, 50, 64, 80, 100, 126, 192),
        ),
        (
            (0, 4, 8, 12, 16, 20, 24, 30, 36, 44, 54, 66, 82, 102, 126, 156,
             194, 240, 296, 364, 448, 550, 576),
            (0, 4, 8, 12, 16, 22, 30, 42, 58, 78, 104, 138, 180, 192),
        ),
    ),
    (  # MPEG-2
        (
            (0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
             238, 284, 336, 396, 464, 522, 576),
            (0, 4, 8, 12, 18, 24, 32, 42, 56, 74, 100, 132, 174, 192),
        ),
        (
            (0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 114, 136, 162, 194,
             232, 278, 332, 394, 464, 540, 576),
            (0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 136, 180, 192),
        ),
        (
            (0, 6, 12, 18, 24, 30, 36, 44, 54, 66, 80, 96, 116, 140, 168, 200,
             238, 284, 336, 396, 464, 522, 576),
            (0, 4, 8, 12, 18, 26, 36, 48, 62, 80, 104, 134, 174, 192),
        ),
    ),
)


# ---------------------------------------------------------------------------
# Packed device-interface layout constants — the single source of truth for
# native/mp3parse.cpp emitters (via native/lib.py) and the device unpackers
# (ops/granule.py). See native/lib.py for the field maps.
# ---------------------------------------------------------------------------
META_WIDTH = 24  # int32 meta words per granule (native raw interface)
SIDE_WIDTH = 144  # int16 words per granule: 22 meta + 44 sfl + 78 sfs
SIDE8_WIDTH = 168  # bytes per granule: 44 meta (LE i16) + 44 sfl + 78 sfs + 2
# int8 interface: a dense int16 HEAD plane carries per-channel lines
# 0..HEAD_LINES-1 exactly (the only place |value| > 127 occurs on real
# streams — big spectral magnitudes live at low frequencies), and an int8
# TAIL plane carries lines HEAD_LINES..575. A tail line that would clip
# sets a sticky overflow and callers fall back to the int16 interface.
# The head replaces the former scatter-applied escape list: unpacking is
# a pure concatenate, with no gather/scatter on the device.
# 64 is measured-minimal, not arbitrary: mpeg2.mp3 carries |value| > 127
# up to per-channel line 63 (classic_lame only to line 16), so any
# smaller head would trip the int8 overflow fallback on real low-rate
# speech and force whole-corpus int16 shipping.
HEAD_LINES = 64  # per-channel int16 head lines
HEAD_WIDTH = 2 * HEAD_LINES  # int16 words per granule (both channels)
SP8_TAIL_WIDTH = 2 * (576 - HEAD_LINES)  # int8 tail bytes per granule
