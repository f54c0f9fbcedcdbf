"""Multi-stream corpus decoding on one device."""

from .corpus import (
    CorpusResult,
    decode_corpus,
    decode_corpus_fast,
    parse_stream_granules,
)

__all__ = [
    "CorpusResult",
    "decode_corpus",
    "decode_corpus_fast",
    "parse_stream_granules",
]
