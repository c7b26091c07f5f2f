"""Utilities: sweep checkpointing, profiling."""

from .checkpoint import SweepCheckpoint
from .profiling import StageTimer, device_trace, sync

__all__ = ["StageTimer", "SweepCheckpoint", "device_trace", "sync"]
