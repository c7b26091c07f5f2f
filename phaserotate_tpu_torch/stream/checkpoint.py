"""Streaming-state serialization (torch).

Counterpart of ``phaserotate_tpu/stream/checkpoint.py`` with the same
``.npz`` format: fields ``spec_hist`` (real/imag float32 pairs, the JAX
package's "ri" layout), ``time_hist``, ``tail``, ``angle``, an optional
``__geom__`` and ``__host_<name>__`` staging arrays.  A checkpoint written
by either package loads into the other and continues the stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.convert import stream_state_from_jax, stream_state_to_jax
from ..core.sizes import StreamGeometry
from .engine import StreamState

__all__ = ["save_stream_state", "load_stream_state"]

_FIELDS = ("spec_hist", "time_hist", "tail", "angle")


def save_stream_state(path: str, state: StreamState,
                      geom: Optional[StreamGeometry] = None,
                      host: Optional[dict] = None) -> None:
    """Serialize a :class:`StreamState` (any batch shape) to ``path``.

    ``host`` optionally carries host-shell staging arrays (the partial
    frame and the staged output block a StreamingRotator holds between
    device calls) so a resumed stream is bit-identical from the very
    first sample."""
    payload = stream_state_to_jax(state)
    if geom is not None:
        payload["__geom__"] = np.array(
            [geom.rate, geom.fftlen, geom.firlen], np.float64)
    for k, v in (host or {}).items():
        payload[f"__host_{k}__"] = np.asarray(v)
    np.savez(path, **payload)


def load_stream_state(path: str, device=None):
    """Load a stream state onto ``device``; returns (state, geom_or_None,
    host_dict)."""
    # a checkpoint is untrusted input: never deserialize objects
    with np.load(path, allow_pickle=False) as z:
        state = stream_state_from_jax({f: z[f] for f in _FIELDS}, device)
        geom = None
        if "__geom__" in z.files:
            rate, fftlen, firlen = z["__geom__"]
            geom = StreamGeometry(
                rate=float(rate), fftlen=int(fftlen), firlen=int(firlen))
        host = {
            k[len("__host_"):-2]: z[k]
            for k in z.files if k.startswith("__host_")
        }
    return state, geom, host
