"""Buffered byte source over a Python binary stream.

Mirrors the reference's `source` (go-mp3 source.go:22-122):
 - `read_full(n)` reads exactly n bytes or returns fewer with eof=True,
 - `unread(buf)` pushes bytes back in front of the stream,
 - `skip_tags()` skips any leading ID3v2 (syncsafe size) and ID3v1 "TAG"
   blocks, including multiple consecutive ID3v2 tags,
 - `seek`/`rewind` are available when the underlying stream is seekable.
"""

from __future__ import annotations

import io
from typing import BinaryIO

from ..consts import MP3Error


class NotSeekableError(MP3Error):
    def __init__(self) -> None:
        super().__init__("mp3: source must be seekable")


class Source:
    __slots__ = ("reader", "buf", "pos")

    def __init__(self, reader: BinaryIO):
        self.reader = reader
        self.buf = b""
        self.pos = 0

    # -- capabilities -------------------------------------------------------
    def seekable(self) -> bool:
        try:
            return self.reader.seekable()
        except AttributeError:
            return hasattr(self.reader, "seek")

    def seek(self, position: int, whence: int = io.SEEK_SET) -> int:
        if not self.seekable():
            raise NotSeekableError()
        self.buf = b""
        n = self.reader.seek(position, whence)
        self.pos = n
        return n

    def rewind(self) -> None:
        self.seek(0, io.SEEK_SET)
        self.pos = 0
        self.buf = b""

    # -- reading ------------------------------------------------------------
    def unread(self, buf: bytes) -> None:
        self.buf = buf + self.buf
        self.pos -= len(buf)

    def read_full(self, n: int) -> tuple[bytes, bool]:
        """Read exactly n bytes. Returns (data, eof). eof=True means the
        stream ended before n bytes were available; data then holds what was
        read (ref: source.go:99-122, short reads surface as io.EOF)."""
        out = b""
        if self.buf:
            out = self.buf[:n]
            self.buf = self.buf[len(out):]
            if len(out) == n:
                return out, False
        want = n - len(out)
        data = self.reader.read(want)
        if data is None:
            data = b""
        self.pos += len(data)
        out += data
        return out, len(out) < n

    # -- tag skipping -------------------------------------------------------
    def skip_tags(self) -> None:
        """Skip any leading ID3v1 ("TAG", 128 bytes total) and ID3v2 blocks
        at the current position (ref: source.go:42-83). Loops so multiple
        consecutive tags are all skipped."""
        while True:
            head, eof = self.read_full(3)
            if eof:
                return
            if head == b"TAG":
                _, eof = self.read_full(125)
                if eof:
                    return
            elif head == b"ID3":
                # version (2) + flags (1)
                _, eof = self.read_full(3)
                if eof:
                    return
                szb, eof = self.read_full(4)
                if len(szb) != 4:
                    return
                size = (
                    (szb[0] << 21) | (szb[1] << 14) | (szb[2] << 7) | szb[3]
                )
                _, eof = self.read_full(size)
                if eof:
                    return
            else:
                self.unread(head)
                return
