"""go_mp3_tpu_torch: the go_mp3_tpu decoder's device DSP in PyTorch, with
hand-written CUDA kernels for Hopper.

Entry points (the same two as the JAX package's):
 - Decoder: the streaming decoder (read/seek/length/checkpoint), its
   granule DSP on a CUDA device (or, when asked, the plain chain on the CPU);
 - decode_corpus_fast: many independent streams decoded in lockstep chunks.

The package imports torch and the JAX-free parts of go_mp3_tpu (consts,
bitstream, native parser, the decoder base class); it never imports jax.
"""

from .decoder import Decoder
from .device import resolve_device
from .parallel.corpus import CorpusResult, decode_corpus_fast

__all__ = ["CorpusResult", "Decoder", "decode_corpus_fast", "resolve_device"]
