"""MSB-first bit reader over a byte buffer, with sticky out-of-bounds error.

Semantics mirror the reference bit reader (go-mp3 internal/bits/bits.go):
 - reads are MSB-first within each byte,
 - reading past the end sets a sticky error and returns 0 WITHOUT advancing,
 - position is settable in bits (used to skip stuffing after part2_3_length),
 - `append`/`tail` support bit-reservoir assembly.
"""

from __future__ import annotations


class BitReader:
    __slots__ = ("vec", "bit_pos", "byte_pos", "err")

    def __init__(self, vec: bytes):
        self.vec = vec
        self.bit_pos = 0  # 0..7 inside current byte
        self.byte_pos = 0
        self.err: str | None = None

    def bit(self) -> int:
        """Read one bit. Past-the-end reads set the sticky error and return 0
        without advancing (ref: bits.go:45-56)."""
        if self.byte_pos >= len(self.vec):
            self.err = "out of bounds"
            return 0
        tmp = (self.vec[self.byte_pos] >> (7 - self.bit_pos)) & 0x01
        self.byte_pos += (self.bit_pos + 1) >> 3
        self.bit_pos = (self.bit_pos + 1) & 0x07
        return tmp

    def bits(self, num: int) -> int:
        """Read `num` bits (0..24 used by MP3) as an unsigned int.
        Insufficient remaining bits set the sticky error and return 0 without
        advancing (ref: bits.go:58-77)."""
        if num == 0:
            return 0
        vec = self.vec
        byte_pos = self.byte_pos
        bit_pos = self.bit_pos
        if (byte_pos << 3) + bit_pos + num > len(vec) << 3:
            self.err = "out of bounds"
            return 0
        # Gather up to 4 bytes (max read is 24 bits + 7 bit offset < 32).
        end = byte_pos + 4
        chunk = vec[byte_pos:end]
        tmp = int.from_bytes(chunk, "big") << (8 * (4 - len(chunk)))
        tmp = (tmp << bit_pos) & 0xFFFFFFFF
        tmp >>= 32 - num
        self.byte_pos = byte_pos + ((bit_pos + num) >> 3)
        self.bit_pos = (bit_pos + num) & 0x07
        return tmp

    def bit_pos_total(self) -> int:
        return (self.byte_pos << 3) + self.bit_pos

    def set_pos(self, pos: int) -> None:
        self.byte_pos = pos >> 3
        self.bit_pos = pos & 0x7

    def len_in_bytes(self) -> int:
        return len(self.vec)

    def tail(self, offset: int) -> bytes:
        """Last `offset` bytes of the underlying buffer (reservoir carry,
        ref: bits.go:92-94)."""
        if offset == 0:
            return b""
        return self.vec[len(self.vec) - offset:]


def append(reader: BitReader, buf: bytes) -> BitReader:
    """New reader over reader's buffer extended with `buf`, position reset
    (ref: bits.go:41-43)."""
    return BitReader(reader.vec + buf)
