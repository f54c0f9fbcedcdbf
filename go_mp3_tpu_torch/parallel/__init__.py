"""Multi-stream corpus decoding."""
