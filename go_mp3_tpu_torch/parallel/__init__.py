"""Multi-stream decoding: the stream mesh and the corpus entry points
(go_mp3_tpu.parallel's names)."""

from .corpus import (
    CorpusResult,
    decode_corpus,
    decode_corpus_fast,
    parse_stream_granules,
)
from .mesh import STREAM_AXIS, init_states, make_mesh, make_sharded_decoder

__all__ = [
    "CorpusResult",
    "decode_corpus",
    "decode_corpus_fast",
    "parse_stream_granules",
    "STREAM_AXIS",
    "init_states",
    "make_mesh",
    "make_sharded_decoder",
]
