"""Host -> device pipeline of the pure-Python parse path: pack parsed
frames into GranuleBatches and decode them in fixed-size chunks on the card.

Counterpart of go_mp3_tpu/models/pipeline.py: granules_from_frame and
pack_granule_batch stage the pure-Python parser's frames as the JAX package
does (numpy, the short/mixed reorder applied on the host), and
StreamDecoder carries one stream's DecodeState on the device across chunks
that go through ops.kernels.decode_chunk on the GranuleBatch route of K1
(inside the chain kernel on the card).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..bitstream.parser import ParsedFrame
from ..consts import SAMPLES_PER_GR

from ..device import resolve_device
from ..ops import tables as T
from ..ops.granule import (
    BATCH_FIELDS,
    DecodeState,
    GranuleBatch,
    batch_to,
    granule_batch_from_numpy,
    init_state,
)
from ..ops.kernels import decode_chunk

DEFAULT_CHUNK = 128  # granules per device call
_NUMPY_DTYPES = {torch.int16: np.int16, torch.int32: np.int32, torch.bool: np.bool_}


@dataclass
class GranuleMeta:
    """Host-side staging for one granule (numpy, pre-device)."""

    spectra: np.ndarray  # int32 [2, 576]
    scalefac_l: np.ndarray  # int32 [2, 22]
    scalefac_s: np.ndarray  # int32 [2, 13, 3]
    global_gain: np.ndarray  # int32 [2]
    scalefac_scale: np.ndarray
    preflag: np.ndarray
    subblock_gain: np.ndarray  # int32 [2, 3]
    block_type: np.ndarray  # int32 [2]
    block_class: np.ndarray  # int32 [2]
    variant: int
    ms_flag: bool
    is_flag: bool
    count1_r: int
    mono: bool


def granules_from_frame(f: ParsedFrame) -> list[GranuleMeta]:
    """Split one parsed frame into per-granule metadata records, with the
    spectra in the post-reorder layout the chain reads."""
    h, si, md = f.header, f.side_info, f.main_data
    nch = h.number_of_channels
    variant = h.low_sampling_frequency * 3 + h.sampling_frequency
    out = []
    for gr in range(h.granules):
        block_class = np.zeros(2, dtype=np.int32)
        spectra = md.is_[gr].copy()
        for ch in range(nch):
            block_class[ch] = T.block_class(
                si.win_switch_flag[gr][ch],
                si.block_type[gr][ch],
                si.mixed_block_flag[gr][ch],
            )
            if block_class[ch] == T.CLASS_SHORT:
                spectra[ch] = spectra[ch][T.REORDER_PERM_SHORT[variant]]
            elif block_class[ch] == T.CLASS_MIXED:
                spectra[ch] = spectra[ch][T.REORDER_PERM_MIXED[variant]]
        out.append(GranuleMeta(
            spectra=spectra,
            scalefac_l=md.scalefac_l[gr].copy(),
            scalefac_s=md.scalefac_s[gr].copy(),
            global_gain=np.array(si.global_gain[gr], dtype=np.int32),
            scalefac_scale=np.array(si.scalefac_scale[gr], dtype=np.int32),
            preflag=np.array(si.preflag[gr], dtype=np.int32),
            subblock_gain=np.array(si.subblock_gain[gr], dtype=np.int32),
            block_type=np.array(si.block_type[gr], dtype=np.int32),
            block_class=block_class,
            variant=variant,
            ms_flag=h.use_ms_stereo,
            is_flag=h.use_intensity_stereo,
            count1_r=si.count1[gr][1] if nch == 2 else si.count1[gr][0],
            mono=(nch == 1),
        ))
    return out


def pack_granule_batch(
    granules: list[GranuleMeta], pad_to: int | None = None
) -> tuple[GranuleBatch, int]:
    """Stack granule records into a GranuleBatch of CPU tensors [1, T, ...],
    zero-padded to T = `pad_to`. Returns (batch, valid_count)."""
    n = len(granules)
    t_dim = pad_to if pad_to is not None else n
    if t_dim < n:
        raise ValueError(f"pad_to {t_dim} < {n} granules")

    def stack(name):
        dtype, inner = BATCH_FIELDS[name]
        arr = np.zeros((t_dim, *inner), dtype=_NUMPY_DTYPES[dtype])
        for i, g in enumerate(granules):
            arr[i] = getattr(g, name)
        return arr

    fields = [stack(name) for name in GranuleBatch._fields]
    return granule_batch_from_numpy(fields, "cpu"), n


@dataclass
class StreamDecoder:
    """Chunked decoding of one stream on `device` (None means CUDA), with
    its DSP state carried there."""

    chunk_size: int = DEFAULT_CHUNK
    state: DecodeState | None = None
    _pending: list[GranuleMeta] = field(default_factory=list)
    device: torch.device | str | None = field(default=None, kw_only=True)

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.state is None:
            self.state = init_state(1, self.device)

    def reset(self) -> None:
        self.state = init_state(1, self.device)
        self._pending.clear()

    def feed_frame(self, f: ParsedFrame) -> None:
        self._pending.extend(granules_from_frame(f))

    def ready_granules(self) -> int:
        return len(self._pending)

    def decode_pending(self, flush: bool = False) -> bytes:
        """Decode buffered granules in full chunks (all of them if flush)."""
        out = b""
        while len(self._pending) >= self.chunk_size or (flush and self._pending):
            take = min(self.chunk_size, len(self._pending))
            chunk, rest = self._pending[:take], self._pending[take:]
            batch, valid = pack_granule_batch(chunk, pad_to=self.chunk_size)
            pcm, self.state = decode_chunk(
                batch_to(batch, self.device), self.state,
                torch.tensor([valid], dtype=torch.int32, device=self.device),
            )
            out += pcm[0, : valid * SAMPLES_PER_GR].cpu().numpy().tobytes()
            self._pending = rest
        return out
