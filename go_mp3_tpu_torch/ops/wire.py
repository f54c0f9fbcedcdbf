"""The fused one-buffer chunk wire, built on the host (numpy only).

Counterparts of build_fused_chunk, build_fused_chunk_mono and the tail-cap
helpers of go_mp3_tpu/parallel/corpus.py (:57-171), and of
fused_stream_nbytes(_mono) in go_mp3_tpu/ops/granule.py (:654, :686). They
live here because importing them from go_mp3_tpu.parallel or go_mp3_tpu.ops
imports jax; the tests hold them byte for byte against the originals.

One row per stream, in this order:
  tail  int8, channel-major and line-major [nch, L, T]: per-channel tail
        lines 0..L-1 (spectral lines 64..64+L-1), each over the T granules;
        lines past L are zero in every granule of the chunk (the caller
        checks that with tail_need_lines);
  head  the int16 head lines as little-endian byte pairs, [T, 128] for a
        stereo row or channel 0's [T, 64] for a mono row;
  side  the byte sidecar [T, 168].
nch = 2 for a stereo row; nch = 1 for a mono row, whose channel 1 is all
zero by the parser's contract and is rebuilt as zeros on the device.
On the card, K1's fused route (kernels.requant_stereo_fused,
csrc/requant_stereo.cu) reads the rows themselves; kernel K4
(csrc/unpack_fused.cu) serves only the public unpack_fused, which turns
them back into K1's three int8-interface arrays.
"""

from __future__ import annotations

import numpy as np

from ..consts import HEAD_LINES, HEAD_WIDTH, SIDE8_WIDTH
from ..native.lib import pack_fused_tail

TAIL_LINES_FULL = 512  # per-channel tail lines: 576 - HEAD_LINES


def fused_stream_nbytes(t: int, tail_lines: int = TAIL_LINES_FULL) -> int:
    """Bytes per stream row of a stereo fused chunk."""
    return 2 * tail_lines * t + t * 2 * HEAD_WIDTH + t * SIDE8_WIDTH


def fused_stream_nbytes_mono(t: int, tail_lines: int = TAIL_LINES_FULL) -> int:
    """Bytes per stream row of a mono fused chunk (channel 0 only)."""
    return tail_lines * t + t * 2 * HEAD_LINES + t * SIDE8_WIDTH


def stream_nbytes(t: int, tail_lines: int, mono: bool) -> int:
    return (fused_stream_nbytes_mono if mono else fused_stream_nbytes)(t, tail_lines)


def build_fused_chunk(
    spectra: np.ndarray,
    head: np.ndarray,
    side: np.ndarray,
    tail_lines: int = TAIL_LINES_FULL,
    out: np.ndarray | None = None,
    native: bool = True,
) -> np.ndarray:
    """Pack one parsed chunk (tail8 [S,T,1024] i8, head16 [S,T,128] i16,
    side8 [S,T,168] u8) into stereo fused rows [S, fused_stream_nbytes]
    u8. `out` may be any C-contiguous [S, n] u8 array (e.g. one chunk of
    a [k, S, n] stack). native=False takes the numpy transpose,
    the equality oracle of the C++ one."""
    return _build(spectra, head, side, tail_lines, out, native, nch=2)


def build_fused_chunk_mono(
    spectra: np.ndarray,
    head: np.ndarray,
    side: np.ndarray,
    tail_lines: int = TAIL_LINES_FULL,
    out: np.ndarray | None = None,
    native: bool = True,
) -> np.ndarray:
    """build_fused_chunk for mono lanes: only channel 0's planes ship. The
    caller must have checked that every valid granule is mono
    (chunk_all_mono)."""
    return _build(spectra, head, side, tail_lines, out, native, nch=1)


def _build(spectra, head, side, tail_lines, out, native, nch):
    s, t = spectra.shape[:2]
    head_lines = HEAD_WIDTH if nch == 2 else HEAD_LINES
    a = nch * tail_lines * t
    b = a + t * 2 * head_lines
    buf = out
    if buf is None:
        buf = np.empty((s, b + t * SIDE8_WIDTH), np.uint8)
    elif buf.shape != (s, b + t * SIDE8_WIDTH) or not buf.flags.c_contiguous:
        # the region views below would silently write into copies
        raise ValueError(f"out: shape {buf.shape}, expected a contiguous "
                         f"{(s, b + t * SIDE8_WIDTH)} u8 array")
    if not (native and pack_fused_tail(spectra, buf, tail_lines, nch=nch)):
        buf[:, :a].reshape(s, nch, tail_lines, t)[:] = spectra.reshape(
            s, t, 2, TAIL_LINES_FULL
        )[:, :, :nch].transpose(0, 2, 3, 1)[:, :, :tail_lines].view(np.uint8)
    buf[:, a:b].reshape(s, t, head_lines, 2)[:] = head.view(np.uint8).reshape(
        s, t, HEAD_WIDTH, 2
    )[:, :, :head_lines]
    buf[:, b:].reshape(s, t, SIDE8_WIDTH)[:] = side
    return buf


def chunk_all_mono(side: np.ndarray, valids: np.ndarray) -> bool:
    """True iff every valid granule of the chunk has the mono bit set
    (sidecar meta word 1, bit 2)."""
    for s in range(side.shape[0]):
        v = int(valids[s])
        if v and not (side[s, :v, 2] & 4).all():
            return False
    return True


def tail_need_lines(spectra: np.ndarray) -> int:
    """Per-channel tail-line extent of the chunk: the number of leading
    tail lines that covers every nonzero line (spectra [S,T,1024] i8, the
    post-reorder lines, so the extent is exact)."""
    nz = spectra.reshape(-1, 2, TAIL_LINES_FULL).any(axis=(0, 1))
    idx = np.nonzero(nz)[0]
    return int(idx.max()) + 1 if idx.size else 0


def bucket_tail_lines(need: int, buckets=(448, 512)) -> int:
    """Smallest bucket >= need; 512 when none fits (buckets past 512 are
    ignored)."""
    for w in buckets:
        if need <= w <= TAIL_LINES_FULL:
            return w
    return TAIL_LINES_FULL


def tail_cap_lines(spectra: np.ndarray, buckets=(448, 512)) -> int:
    """bucket_tail_lines(tail_need_lines(spectra), buckets)."""
    return bucket_tail_lines(tail_need_lines(spectra), buckets)
