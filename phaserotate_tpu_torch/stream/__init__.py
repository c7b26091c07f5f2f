"""Streaming engine: the per-block OLA core and the host-block shell."""

from .checkpoint import load_stream_state, save_stream_state
from .engine import (
    StreamState,
    init_state,
    rotate_streamed,
    stream_process,
    stream_process_bulk,
    stream_step,
)
from .host import StreamingRotator

__all__ = [
    "StreamState",
    "StreamingRotator",
    "init_state",
    "load_stream_state",
    "rotate_streamed",
    "save_stream_state",
    "stream_process",
    "stream_process_bulk",
    "stream_step",
]
