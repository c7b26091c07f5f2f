"""Utilities: sweep checkpointing."""

from .checkpoint import SweepCheckpoint

__all__ = ["SweepCheckpoint"]
