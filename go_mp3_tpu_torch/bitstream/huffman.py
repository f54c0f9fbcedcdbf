"""Layer III Huffman decoding via flat lookup tables.

Built on the canonical codebooks in huffman_tables.py. Instead of the
reference's bit-by-bit tree walk (go-mp3 internal/huffman/
huffman.go:348-419) we peek `maxlen` bits and resolve the symbol in one table
lookup — same consumed bit counts, same outputs, one memory access per symbol.

Escape handling matches the reference exactly: for big-value books, linbits
are added when |x|==15 before the sign bit; for the count1 books (32/33) the
4-bit leaf packs (v,w,x,y) and sign bits follow in v,w,x,y order.
"""

from __future__ import annotations

import numpy as np

from ..consts import MP3Error
from .bits import BitReader
from .huffman_tables import TABLES

# Per distinct codebook: (maxlen, lut) where lut[window] = length<<8 | x<<4 | y
_LUTS: dict[int, tuple[int, np.ndarray]] = {}
# Per table number 0..33: (maxlen, lut, linbits) or None for empty tables.
_TABLE_LUTS: list[tuple[int, np.ndarray, int] | None] = []


def _build() -> None:
    built: dict[int, tuple[int, np.ndarray]] = {}
    for codebook, linbits in TABLES:
        if codebook is None:
            _TABLE_LUTS.append(None)
            continue
        key = id(codebook)
        if key not in built:
            maxlen = max(length for length, _, _, _ in codebook)
            lut = np.zeros(1 << maxlen, dtype=np.uint32)
            for length, code, x, y in codebook:
                lo = code << (maxlen - length)
                hi = (code + 1) << (maxlen - length)
                lut[lo:hi] = (length << 8) | (x << 4) | y
            built[key] = (maxlen, lut)
        maxlen, lut = built[key]
        _TABLE_LUTS.append((maxlen, lut, linbits))


_build()


def _peek(reader: BitReader, num: int) -> int:
    """Peek `num` bits zero-padded past the end, without moving the reader.

    Zero-padding reproduces the reference's sticky-error semantics where
    reads past the end return 0 bits (bits.go:45-56)."""
    byte_pos = reader.byte_pos
    bit_pos = reader.bit_pos
    vec = reader.vec
    nbytes = (bit_pos + num + 7) >> 3
    chunk = vec[byte_pos : byte_pos + nbytes]
    window = int.from_bytes(chunk, "big")
    pad = nbytes - len(chunk)
    if pad:
        window <<= 8 * pad
    total = 8 * nbytes
    window >>= total - bit_pos - num
    return window & ((1 << num) - 1)


def decode(reader: BitReader, table_num: int) -> tuple[int, int, int, int]:
    """Decode one Huffman word from `reader` using table `table_num`.

    Returns (x, y, v, w). Big-value tables fill x/y (linbits and sign
    applied); count1 tables (32/33) fill all of v/w/x/y with values in
    {-1, 0, 1}. Empty tables return all zeros without consuming bits.
    """
    entry = _TABLE_LUTS[table_num]
    if entry is None:
        return 0, 0, 0, 0
    maxlen, lut, linbits = entry

    window = _peek(reader, maxlen)
    packed = int(lut[window])
    length = packed >> 8
    if length == 0:  # unreachable with the shipped (complete) codebooks
        raise MP3Error(f"mp3: illegal Huffman code in data, tab = {table_num}")
    remaining = (len(reader.vec) << 3) - reader.bit_pos_total()
    if length > remaining:
        # The walker would consume all remaining bits and then read sticky
        # zeros without advancing: land exactly at the end of the buffer.
        reader.set_pos(len(reader.vec) << 3)
        reader.err = "out of bounds"
    else:
        reader.set_pos(reader.bit_pos_total() + length)
    x = (packed >> 4) & 0xF
    y = packed & 0xF

    if table_num > 31:
        v = (y >> 3) & 1
        w = (y >> 2) & 1
        x = (y >> 1) & 1
        y &= 1
        if v and reader.bit() == 1:
            v = -v
        if w and reader.bit() == 1:
            w = -w
        if x and reader.bit() == 1:
            x = -x
        if y and reader.bit() == 1:
            y = -y
        return x, y, v, w

    if linbits and x == 15:
        x += reader.bits(linbits)
    if x and reader.bit() == 1:
        x = -x
    if linbits and y == 15:
        y += reader.bits(linbits)
    if y and reader.bit() == 1:
        y = -y
    return x, y, 0, 0
