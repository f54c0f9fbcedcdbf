"""Utility subsystems: serializable decode state (checkpoint/resume)."""

from .state import checkpoint_from_bytes, checkpoint_to_bytes

__all__ = ["checkpoint_from_bytes", "checkpoint_to_bytes"]
