"""Host -> device pipelines: granule batching and chunked stream decoding."""

from .pipeline import (
    DEFAULT_CHUNK,
    GranuleMeta,
    StreamDecoder,
    granules_from_frame,
    pack_granule_batch,
)

__all__ = [
    "DEFAULT_CHUNK",
    "GranuleMeta",
    "StreamDecoder",
    "granules_from_frame",
    "pack_granule_batch",
]
