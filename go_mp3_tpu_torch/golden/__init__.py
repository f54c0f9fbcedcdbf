"""The golden backend's oracle: the numpy float64 decoder chain
(reference_dsp.GoldenDecoder) with its tables, a copy of the JAX package's
that reads the port's own bitstream classes."""

from .reference_dsp import GoldenDecoder

__all__ = ["GoldenDecoder"]
