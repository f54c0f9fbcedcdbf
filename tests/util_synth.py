"""Synthetic bitstream builders for hermetic tests (no real files needed).

Modeled on the reference's approach of constructing a minimal valid MPEG-1
Layer III frame plus tag blocks in code (trailing_tags_test.go:15-98), but
built from the header field definitions rather than copied bytes.
"""

from __future__ import annotations


def mpeg1_layer3_header(
    bitrate_index: int = 9,  # 128 kbps
    sampling_frequency: int = 0,  # 44.1 kHz
    padding: int = 0,
    mode: int = 0,  # stereo
    protection: int = 1,  # 1 = no CRC
) -> int:
    """Assemble a valid MPEG-1 Layer III header word."""
    return (
        0xFFE00000
        | (3 << 19)  # version: MPEG-1
        | (1 << 17)  # layer: III
        | (protection << 16)
        | (bitrate_index << 12)
        | (sampling_frequency << 10)
        | (padding << 9)
        | (mode << 6)
    )


def silent_frame(
    bitrate_index: int = 9,
    sampling_frequency: int = 0,
    mode: int = 0,
) -> bytes:
    """A complete, valid MPEG-1 Layer III frame whose side info is all zeros
    (part2_3_length == 0 for every granule/channel), which decodes to silence.

    At 128 kbps / 44.1 kHz this is 417 bytes (144 * 128000 / 44100 = 417)."""
    word = mpeg1_layer3_header(bitrate_index, sampling_frequency, 0, mode)
    bitrates = {9: 128000, 10: 160000, 11: 192000, 12: 224000, 14: 320000}
    freqs = {0: 44100, 1: 48000, 2: 32000}
    size = (144 * bitrates[bitrate_index]) // freqs[sampling_frequency]
    frame = bytearray(size)
    frame[0:4] = word.to_bytes(4, "big")
    return bytes(frame)


def id3v1_tag() -> bytes:
    tag = bytearray(128)
    tag[0:3] = b"TAG"
    tag[3:8] = b"title"
    return bytes(tag)


def id3v2_tag(payload_size: int) -> bytes:
    """ID3v2 block with a syncsafe-encoded payload size."""
    assert payload_size < (1 << 28)
    hdr = bytearray(10)
    hdr[0:3] = b"ID3"
    hdr[3] = 4  # version
    hdr[4] = 0
    hdr[5] = 0  # flags
    hdr[6] = (payload_size >> 21) & 0x7F
    hdr[7] = (payload_size >> 14) & 0x7F
    hdr[8] = (payload_size >> 7) & 0x7F
    hdr[9] = payload_size & 0x7F
    return bytes(hdr) + bytes(payload_size)


def apev2_tag(n_items: int = 1) -> bytes:
    """Minimal APEv2 tag block (header + tiny items + footer)."""
    items = b""
    for i in range(n_items):
        key = f"key{i}".encode()
        val = b"value"
        items += (
            len(val).to_bytes(4, "little") + (0).to_bytes(4, "little")
            + key + b"\x00" + val
        )
    size = len(items) + 32  # tag size includes footer
    def block(flags: int) -> bytes:
        return (
            b"APETAGEX"
            + (2000).to_bytes(4, "little")
            + size.to_bytes(4, "little")
            + n_items.to_bytes(4, "little")
            + flags.to_bytes(4, "little")
            + bytes(8)
        )
    return block(0xA0000000) + items + block(0x80000000)


class _BitWriter:
    """MSB-first bit packer for hand-built frames."""

    def __init__(self) -> None:
        self.bits: list[int] = []

    def write(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bits.append((value >> k) & 1)

    def tobytes(self, pad_to: int | None = None) -> bytes:
        bits = list(self.bits)
        while len(bits) % 8:
            bits.append(0)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        if pad_to is not None:
            out.extend(b"\x00" * (pad_to - len(out)))
        return bytes(out)


def low_bitrate_mpeg2_stream(n_fillers: int = 19, n_trailing: int = 6):
    """A valid 8 kbps MPEG-2 mono stream (26-byte frames, 13 main-data bytes
    each) whose frame `n_fillers` carries real spectral content with
    main_data_begin spanning ALL previous frames' main data — the
    pathological case for seek warm-up: a fixed small warm-up window (the
    reference's 1 frame, or this repo's former 8-frame cap) cannot recharge
    the reservoir, so seeking past the content frame only lands
    bit-identical to a linear decode if the warm-up depth is derived from
    the real frame geometry.

    Layout: `n_fillers` frames with part2_3_length == 0 whose main-data
    bytes hold the content frame's Huffman bits (each declares the full
    running backlog as main_data_begin so the reservoir carries forward),
    then the content frame (main_data_begin == 13 * n_fillers, big-value
    pairs of ±1 via Huffman table 1 across all three regions), then
    `n_trailing` silent frames. Returns (stream bytes, content frame index,
    total frame count)."""
    from go_mp3_tpu.bitstream.huffman_tables import TABLES

    assert 13 * n_fillers <= 255, "MPEG-2 main_data_begin is 8 bits"
    header_word = (
        0xFFE00000
        | (2 << 19)  # version: MPEG-2
        | (1 << 17)  # layer: III
        | (1 << 16)  # no CRC
        | (1 << 12)  # bitrate index 1 = 8 kbps
        | (0 << 10)  # 22.05 kHz
        | (3 << 6)  # mono
    )
    frame_size = ((144 * 8000) // 22050) >> 1  # 26
    main_bytes = frame_size - 4 - 9  # 13

    # Content granule: big-value (1,1) pairs via table 1 in all regions.
    # region0_count=8, region1_count=3 -> boundaries 66 / 140 from the
    # MPEG-2 22.05 kHz long-band table; big_values=240 covers lines 0..479.
    book, _linbits = TABLES[1]
    length, code = next(
        (e[0], e[1]) for e in book if e[2] == 1 and e[3] == 1
    )
    n_pairs = 240
    md = _BitWriter()
    for p in range(n_pairs):
        md.write(code, length)
        md.write(p & 1, 1)  # x sign (alternating, avoids DC)
        md.write((p >> 1) & 1, 1)  # y sign
    p23 = n_pairs * (length + 2)
    assert p23 < 4096
    content_bits = md.tobytes()

    # The content frame's Huffman bits start at bit 0 of its assembled
    # reservoir = byte 0 of filler 0's main data.
    payload = bytearray(content_bits)
    total_main = (n_fillers + 1) * main_bytes
    assert len(payload) <= total_main, "content must fit the backlog"
    payload.extend(bytes(total_main - len(payload)))

    def side_info(mdb: int, part23: int, big_values: int) -> bytes:
        si = _BitWriter()
        si.write(mdb, 8)  # main_data_begin (8 bits for MPEG-2)
        si.write(0, 1)  # private (mono)
        si.write(part23, 12)
        si.write(big_values, 9)
        si.write(210, 8)  # global_gain -> unit requantize scale
        si.write(0, 9)  # scalefac_compress 0 -> zero scalefactor bits
        si.write(0, 1)  # window_switching: normal long block
        for _ in range(3):
            si.write(1, 5)  # table_select: table 1 everywhere
        si.write(8, 4)  # region0_count
        si.write(3, 3)  # region1_count
        si.write(0, 1)  # scalefac_scale
        si.write(0, 1)  # count1 table
        out = si.tobytes()
        assert len(out) == 9, len(out)
        return out

    frames = []
    for i in range(n_fillers):
        main = payload[i * main_bytes : (i + 1) * main_bytes]
        frames.append(
            header_word.to_bytes(4, "big")
            + side_info(min(13 * i, 255), 0, 0)
            + bytes(main)
        )
    content_main = payload[n_fillers * main_bytes :]
    frames.append(
        header_word.to_bytes(4, "big")
        + side_info(13 * n_fillers, p23, n_pairs)
        + bytes(content_main)
    )
    for _ in range(n_trailing):
        frames.append(
            header_word.to_bytes(4, "big")
            + side_info(0, 0, 0)
            + bytes(main_bytes)
        )
    return b"".join(frames), n_fillers, n_fillers + 1 + n_trailing


def escape_heavy_frame(n_pairs: int = 20, linbit_value: int = 4000,
                       global_gain: int = 210) -> bytes:
    """A valid MONO MPEG-1 Layer III frame whose two granules each carry
    `n_pairs` big-value pairs of (15+linbit, 15+linbit) via Huffman table 23
    (linbits 13) — every coded line has |x| > 127, reaching past the int8
    interface's exact int16 head plane (per-channel lines 0..63) into the
    int8 tail. Exercises the packed8 overflow fallback."""
    from go_mp3_tpu.bitstream.huffman_tables import TABLES

    book, linbits = TABLES[23]
    entry = next(e for e in book if e[2] == 15 and e[3] == 15)
    length, code = entry[0], entry[1]
    pair_bits = length + 2 * (linbits + 1)
    p23 = n_pairs * pair_bits  # no scalefactor bits (scalefac_compress=0)

    # side info: mono MPEG-1, 17 bytes
    si = _BitWriter()
    si.write(0, 9)  # main_data_begin
    si.write(0, 5)  # private
    si.write(0, 4)  # scfsi
    for _gr in range(2):
        si.write(p23, 12)  # part2_3_length
        si.write(n_pairs, 9)  # big_values
        si.write(global_gain, 8)  # global_gain
        si.write(0, 4)  # scalefac_compress -> slen 0/0
        si.write(0, 1)  # window_switching
        si.write(23, 5)  # table_select region0
        si.write(0, 5)  # region1 table (unused: zeros)
        si.write(0, 5)  # region2 table
        si.write(8, 4)  # region0_count -> bands[9]=44 >= 2*n_pairs
        si.write(3, 3)  # region1_count
        si.write(0, 1)  # preflag
        si.write(0, 1)  # scalefac_scale
        si.write(0, 1)  # count1 table
    side = si.tobytes()
    assert len(side) == 17, len(side)

    md = _BitWriter()
    for _gr in range(2):
        for _p in range(n_pairs):
            md.write(code, length)
            md.write(linbit_value, linbits)  # x linbits
            md.write(0, 1)  # x sign +
            md.write(linbit_value, linbits)  # y linbits
            md.write(0, 1)  # y sign +

    word = mpeg1_layer3_header(mode=3)  # mono
    size = (144 * 128000) // 44100  # 417
    main = md.tobytes(pad_to=size - 4 - 17)
    return word.to_bytes(4, "big") + side + main


def tail_escape_frame(n_pairs: int = 40) -> bytes:
    """escape_heavy_frame with its region 1 and 2 tables set to its region
    0 table (23), so the escapes run past line 64 into the int8 tail: the
    fused path overflows and the corpus reruns on int16."""
    frame = bytearray(escape_heavy_frame(n_pairs=n_pairs))
    bits = list("".join(f"{b:08b}" for b in frame[4:21]))  # mono side info
    for gr in range(2):
        for region in (1, 2):
            at = 18 + 59 * gr + 34 + 5 * region  # the granule's table_select
            bits[at:at + 5] = f"{23:05b}"
    frame[4:21] = bytes(int("".join(bits[i:i + 8]), 2) for i in range(0, 136, 8))
    return bytes(frame)


def in_child(child, timeout: float = 120) -> None:
    """Run child() in a forked child, which must return True within
    `timeout` seconds: a child that hangs is killed and fails the test."""
    import os
    import time

    import pytest

    pid = os.fork()
    if pid == 0:
        ok = False
        try:
            ok = child()
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + timeout
    while (done := os.waitpid(pid, os.WNOHANG))[0] == 0 and time.monotonic() < deadline:
        time.sleep(0.05)
    if done[0] == 0:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child hung")
    assert os.waitstatus_to_exitcode(done[1]) == 0
