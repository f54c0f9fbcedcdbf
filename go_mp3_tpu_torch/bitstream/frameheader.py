"""MPEG frame header parsing, validation and sync-word resync.

Mirrors the reference header layer (go-mp3 internal/frameheader/
frameheader.go). The 32-bit header word is kept as an int and decoded with
properties; `read_header` performs the byte-at-a-time resync scan with the
64 KiB cap.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..consts import (
    GRANULES_MPEG1,
    MAX_SYNC_SEARCH_BYTES,
    SAMPLES_PER_GR,
    SAMPLING_FREQUENCY_RESERVED,
    EOFError_,
    Layer,
    Mode,
    MP3Error,
    SyncSearchLimitError,
    UnexpectedEOFError,
    Version,
)
from .source import Source

# Bitrates in bit/s indexed [lsf][layer-1][bitrate_index]
# (ISO 11172-3 / 13818-3 tables; ref frameheader.go:191-221).
_BITRATES = (
    (
        (0, 32000, 40000, 48000, 56000, 64000, 80000, 96000,
         112000, 128000, 160000, 192000, 224000, 256000, 320000, 0),  # L3
        (0, 32000, 48000, 56000, 64000, 80000, 96000, 112000,
         128000, 160000, 192000, 224000, 256000, 320000, 384000, 0),  # L2
        (0, 32000, 64000, 96000, 128000, 160000, 192000, 224000,
         256000, 288000, 320000, 352000, 384000, 416000, 448000, 0),  # L1
    ),
    (
        (0, 8000, 16000, 24000, 32000, 40000, 48000, 56000,
         64000, 80000, 96000, 112000, 128000, 144000, 160000, 0),  # L3
        (0, 8000, 16000, 24000, 32000, 40000, 48000, 56000,
         64000, 80000, 96000, 112000, 128000, 144000, 160000, 0),  # L2
        (0, 32000, 48000, 56000, 64000, 80000, 96000, 112000,
         128000, 144000, 160000, 176000, 192000, 224000, 256000, 0),  # L1
    ),
)


@dataclass(frozen=True)
class FrameHeader:
    """A validated 32-bit MPEG audio frame header."""

    word: int

    @property
    def version(self) -> Version:
        return Version((self.word & 0x00180000) >> 19)

    @property
    def layer(self) -> Layer:
        return Layer((self.word & 0x00060000) >> 17)

    @property
    def protection_bit(self) -> int:
        return (self.word & 0x00010000) >> 16

    @property
    def bitrate_index(self) -> int:
        return (self.word & 0x0000F000) >> 12

    @property
    def sampling_frequency(self) -> int:
        """Raw 2-bit sampling frequency index (0/1/2, 3 reserved)."""
        return (self.word & 0x00000C00) >> 10

    @property
    def padding_bit(self) -> int:
        return (self.word & 0x00000200) >> 9

    @property
    def private_bit(self) -> int:
        return (self.word & 0x00000100) >> 8

    @property
    def mode(self) -> Mode:
        return Mode((self.word & 0x000000C0) >> 6)

    @property
    def mode_extension(self) -> int:
        return (self.word & 0x00000030) >> 4

    @property
    def copyright(self) -> int:
        return (self.word & 0x00000008) >> 3

    @property
    def original_or_copy(self) -> int:
        return (self.word & 0x00000004) >> 2

    @property
    def emphasis(self) -> int:
        return self.word & 0x00000003

    # -- derived ------------------------------------------------------------
    @property
    def low_sampling_frequency(self) -> int:
        """0 for MPEG-1, 1 for MPEG-2/2.5 (ref: frameheader.go:122-128)."""
        return 0 if self.version == Version.MPEG1 else 1

    @property
    def use_ms_stereo(self) -> bool:
        return self.mode == Mode.JOINT_STEREO and bool(self.mode_extension & 0x2)

    @property
    def use_intensity_stereo(self) -> bool:
        return self.mode == Mode.JOINT_STEREO and bool(self.mode_extension & 0x1)

    def sampling_frequency_value(self) -> int:
        """Sample rate in Hz. Raises on the reserved index."""
        lsf = self.low_sampling_frequency
        base = {0: 44100, 1: 48000, 2: 32000}.get(self.sampling_frequency)
        if base is None:
            raise MP3Error("mp3: frame header has invalid sample frequency")
        return base >> lsf

    @property
    def granules(self) -> int:
        return GRANULES_MPEG1 >> self.low_sampling_frequency

    @property
    def samples_per_frame(self) -> int:
        return SAMPLES_PER_GR * self.granules

    @property
    def bytes_per_frame(self) -> int:
        """Decoded PCM bytes per frame: always s16le stereo (4 B/sample)."""
        return SAMPLES_PER_GR * self.granules * 4

    def bytes_per_second(self) -> int:
        return self.sampling_frequency_value() * 4

    def frame_duration_seconds(self) -> float:
        return self.samples_per_frame / self.sampling_frequency_value()

    @property
    def bitrate(self) -> int:
        return _BITRATES[self.low_sampling_frequency][self.layer - 1][
            self.bitrate_index
        ]

    def frame_size(self) -> int:
        """Compressed frame size in bytes incl. the 4-byte header
        (ref: frameheader.go:223-232)."""
        freq = self.sampling_frequency_value()
        return ((144 * self.bitrate) // freq + self.padding_bit) >> (
            self.low_sampling_frequency
        )

    @property
    def side_info_size(self) -> int:
        mono = self.mode == Mode.SINGLE_CHANNEL
        if self.low_sampling_frequency == 1:
            return 9 if mono else 17
        return 17 if mono else 32

    @property
    def number_of_channels(self) -> int:
        return 1 if self.mode == Mode.SINGLE_CHANNEL else 2

    def is_valid(self) -> bool:
        """Layer III-only validity check rejecting false syncs
        (ref: frameheader.go:168-189)."""
        sync = 0xFFE00000
        w = self.word
        if (w & sync) != sync:
            return False
        if self.version == Version.RESERVED:
            return False
        if self.bitrate_index == 15:
            return False
        if self.sampling_frequency == SAMPLING_FREQUENCY_RESERVED:
            return False
        if self.layer != Layer.LAYER3:
            return False
        if self.emphasis == 2:
            return False
        return True


def read_header(source: Source, position: int) -> tuple[FrameHeader, int]:
    """Read 4 bytes and resync byte-at-a-time until a valid header is found,
    scanning at most MAX_SYNC_SEARCH_BYTES (ref: frameheader.go:279-328).

    Returns (header, start_position). Raises EOFError_ on clean EOF at a
    frame boundary, UnexpectedEOFError mid-header, SyncSearchLimitError when
    the cap is hit, and MP3Error for free-bitrate streams.
    """
    buf, eof = source.read_full(4)
    if len(buf) < 4:
        if len(buf) == 0 and eof:
            raise EOFError_()
        raise UnexpectedEOFError("read_header (1)")

    word = int.from_bytes(buf, "big")
    header = FrameHeader(word)
    bytes_searched = 4
    while not header.is_valid():
        if bytes_searched >= MAX_SYNC_SEARCH_BYTES:
            raise SyncSearchLimitError(bytes_searched)
        nxt, eof = source.read_full(1)
        if len(nxt) < 1:
            raise UnexpectedEOFError("read_header (2)")
        word = ((word << 8) & 0xFFFFFFFF) | nxt[0]
        header = FrameHeader(word)
        position += 1
        bytes_searched += 1

    if header.bitrate_index == 0:
        raise MP3Error(
            "mp3: free bitrate format is not supported. "
            f"Header word is 0x{word:08x} at position {position}"
        )
    return header, position
