"""go_mp3_tpu_torch: the go_mp3_tpu decoder with its device DSP in PyTorch,
on hand-written CUDA kernels for Hopper.

The public names of go_mp3_tpu, on the port:
 - Decoder: the streaming decoder (read/seek/length/checkpoint) over
   every source and parse path of go_mp3_tpu's, its granule DSP on a CUDA
   device (or, when asked, the plain chain on the CPU);
 - GaplessDecoder: LAME delay/padding-trimmed decoding over that Decoder;
 - lameinfo and the errors, go_mp3_tpu's own (JAX-free);
and decode_corpus_fast, many independent streams decoded in lockstep
chunks (go_mp3_tpu.parallel.corpus's; decode_corpus and
parse_stream_granules are in go_mp3_tpu_torch.parallel, as there).

The package imports torch and the JAX-free parts of go_mp3_tpu (consts,
bitstream, lameinfo, the native parser, the decoder and gapless base
classes); it never imports jax.
"""

from go_mp3_tpu import lameinfo
from go_mp3_tpu.consts import MP3Error, SyncSearchLimitError, UnexpectedEOFError
from go_mp3_tpu.decoder import NotSeekableError

from .decoder import Decoder
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
