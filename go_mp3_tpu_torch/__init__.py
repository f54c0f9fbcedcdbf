"""go_mp3_tpu_torch: the go_mp3_tpu decoder with its device DSP in PyTorch,
on hand-written CUDA kernels for Hopper.

The public names of go_mp3_tpu, on the port:
 - Decoder: the streaming decoder (read/seek/length/checkpoint) over
   every source and parse path, its granule DSP on a CUDA device (or, when
   asked, the plain chain on the CPU);
 - GaplessDecoder: LAME delay/padding-trimmed decoding over that Decoder;
 - lameinfo and the errors;
and decode_corpus_fast, many independent streams decoded in lockstep
chunks (decode_corpus and parse_stream_granules are in
go_mp3_tpu_torch.parallel, as in the JAX package).

The package stands alone: it imports torch, numpy and its own modules,
among them its own copies of the host layers (consts, bitstream, lameinfo,
the C++ parser and exact DSP, the golden oracle). It imports nothing of
go_mp3_tpu and never jax.
"""

from . import lameinfo
from .consts import MP3Error, SyncSearchLimitError, UnexpectedEOFError
from .decoder import Decoder, NotSeekableError
from .device import resolve_device
from .gapless import GaplessDecoder
from .parallel.corpus import CorpusResult, decode_corpus_fast

__all__ = [
    "CorpusResult",
    "Decoder",
    "GaplessDecoder",
    "MP3Error",
    "NotSeekableError",
    "SyncSearchLimitError",
    "UnexpectedEOFError",
    "decode_corpus_fast",
    "lameinfo",
    "resolve_device",
]
