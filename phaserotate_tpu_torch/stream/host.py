"""Host-block-size-independent streaming wrapper (torch).

Counterpart of ``phaserotate_tpu/stream/host.py``: the plugin's
``run(n_samples)`` contract (src/phaserotate.c:615-725).  The host may push
blocks of any size; the engine advances in ``parsiz`` blocks, staging
partial frames with the reference's offset bookkeeping, and the output
lags the input by ``parsiz + firlen/2`` samples.  Audio blocks stay numpy
on the host; the engine state lives on the rotator's device.

Pipelined mode (``pipeline_depth = D > 0``): instead of waiting for each
frame's output, the shell starts its device-to-host copy (non-blocking,
into a pinned buffer, with an event) and emits the output of the frame
``D`` frames back, whose copy has had ``D`` frames of slack to land.
``D = 0`` is the synchronous contract; ``D > 0`` emits the same stream
delayed by exactly ``D*parsiz`` samples.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.sizes import StreamGeometry, stream_geometry_for_rate
from .engine import init_state, stream_process_batched, stream_step_batched

__all__ = ["StreamingRotator", "advance_stream", "OutputPipeline"]


class OutputPipeline:
    """Depth-``D`` output delay line of in-flight frames.

    ``push_pop(y)`` registers frame output ``y`` ((C, parsiz), a CUDA
    tensor or a host array), starts its host copy, and returns the frame
    from ``D`` pushes ago (zeros until the pipeline fills).  The returned
    array is read before the next push, never written."""

    def __init__(self, depth: int, channels: int, parsiz: int):
        if depth < 0:
            raise ValueError(f"pipeline depth must be >= 0, got {depth}")
        self.depth = int(depth)
        self._zeros = np.zeros((channels, parsiz), np.float32)
        self._pending: collections.deque = collections.deque()
        self._pinned: list = []  # depth+1 pinned buffers, made at first use
        self._next = 0

    def reset(self) -> None:
        self._pending.clear()

    def _pinned_buffer(self) -> torch.Tensor:
        # a buffer is reused depth+1 pushes after it was filled, one push
        # after it was popped
        if not self._pinned:
            self._pinned = [
                torch.empty(self._zeros.shape, dtype=torch.float32,
                            pin_memory=True)
                for _ in range(self.depth + 1)]
        buf = self._pinned[self._next]
        self._next = (self._next + 1) % len(self._pinned)
        return buf

    def push_pop(self, y) -> np.ndarray:
        if isinstance(y, torch.Tensor) and y.device.type == "cuda":
            buf = self._pinned_buffer()
            buf.copy_(y, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(y.device))
            self._pending.append((buf, done))
        elif isinstance(y, torch.Tensor):
            self._pending.append((y.numpy(), None))
        else:
            self._pending.append((np.asarray(y, np.float32), None))
        if len(self._pending) > self.depth:
            host, done = self._pending.popleft()
            if done is None:
                return host
            done.synchronize()
            return host.numpy()
        return self._zeros


def advance_stream(state, cur_in, cur_out, offset, x, degs, geom,
                   pipe: Optional[OutputPipeline] = None):
    """Advance the engine through one host block of any size, with the
    reference's offset bookkeeping (src/phaserotate.c:615-725).

    Complete frames at a frame boundary take the bulk path: one call
    steps all of them, with frame counts bucketed to powers of two; the
    emitted output for frame j is the staged result of frame j-1, the
    same as per-frame stepping.

    Args:
      state: batched engine carry (channels leading axis), on its device.
      cur_in/cur_out: (C, parsiz) numpy staging buffers, mutated in place.
      offset: current intra-frame position.
      x: (C, n) float32 numpy input block.
      degs: (C,) float32 target angles for this block.
      pipe: optional :class:`OutputPipeline`; when given, outputs are
        emitted ``pipe.depth`` frames later instead of waiting for each.

    Returns ``(state, offset, out)`` with out shaped like ``x``.
    """
    parsiz = geom.parsiz
    channels, n = x.shape
    dev = state.tail.device
    tgt = torch.from_numpy(np.asarray(degs, np.float32)).to(dev)
    out = np.empty_like(x)
    pos = 0
    while pos < n:
        if offset == 0 and n - pos >= 2 * parsiz:
            k_avail = (n - pos) // parsiz
            k = 1 << (k_avail.bit_length() - 1)
            frames = torch.from_numpy(np.ascontiguousarray(
                x[:, pos : pos + k * parsiz]).reshape(channels, k, parsiz))
            state, ys = stream_process_batched(state, frames.to(dev), tgt,
                                               geom)
            ys = ys.cpu().numpy()
            if pipe is not None:
                # k frames of budget: one synchronous readback, then
                # frame-wise delay-line bookkeeping
                for i in range(k):
                    out[:, pos + i * parsiz : pos + (i + 1) * parsiz] = \
                        cur_out
                    cur_out[:] = pipe.push_pop(ys[:, i])
                pos += k * parsiz
                continue
            out[:, pos : pos + parsiz] = cur_out
            out[:, pos + parsiz : pos + k * parsiz] = ys[:, :-1].reshape(
                channels, (k - 1) * parsiz)
            cur_out[:] = ys[:, -1]
            pos += k * parsiz
            continue
        ns = min(parsiz - offset, n - pos)
        cur_in[:, offset : offset + ns] = x[:, pos : pos + ns]
        out[:, pos : pos + ns] = cur_out[:, offset : offset + ns]
        offset += ns
        pos += ns
        if offset == parsiz:
            offset = 0
            # the step gets its own snapshot: cur_in is written again
            # while a CUDA step may still be in flight
            frame = torch.from_numpy(cur_in.copy()).to(dev)
            state, y = stream_step_batched(state, frame, tgt, geom)
            if pipe is not None:
                cur_out[:] = pipe.push_pop(y)
            else:
                cur_out[:] = y.cpu().numpy()
    return state, offset, out


class StreamingRotator:
    """Stateful streaming rotator for one or more channels.

    Example::

        rot = StreamingRotator(rate=48000, channels=2, device="cuda")
        out = rot.process(block, degrees=[35.0, 35.0])  # any block length

    ``process`` takes and returns host (numpy) blocks; the engine state
    stays on ``device`` (default: the CUDA device; ``"cpu"`` for the CPU).
    No allocation grows with history.
    """

    def __init__(
        self,
        rate: float = 48000.0,
        channels: int = 1,
        geom: Optional[StreamGeometry] = None,
        pipeline_depth: int = 0,
        device=None,
    ):
        self.geom = geom or stream_geometry_for_rate(rate)
        self.channels = channels
        self.pipeline_depth = int(pipeline_depth)
        self.device = resolve_device(device)
        self.reset()

    @property
    def latency(self) -> int:
        """Samples of output delay (src/phaserotate.c:297, 788), plus the
        pipeline's delay when pipelining is on."""
        return self.geom.latency + self.pipeline_depth * self.geom.parsiz

    def reset(self) -> None:
        """activate() semantics: clear all streaming state
        (src/phaserotate.c:511-520)."""
        parsiz = self.geom.parsiz
        self._state = init_state(self.geom, (self.channels,), self.device)
        self._offset = 0
        self._cur_in = np.zeros((self.channels, parsiz), np.float32)
        self._cur_out = np.zeros((self.channels, parsiz), np.float32)
        self._pipe = (OutputPipeline(self.pipeline_depth, self.channels,
                                     parsiz)
                      if self.pipeline_depth > 0 else None)

    def process(self, block: np.ndarray, degrees) -> np.ndarray:
        """Process one host block.

        Args:
          block: (channels, n) or (n,) float32.
          degrees: scalar or per-channel sequence — the control-port value
            for this host block (read once per run(), src/phaserotate.c:564).

        Returns the same-shaped output block (delayed by ``latency``).
        """
        squeeze = np.ndim(block) == 1
        x = np.atleast_2d(np.asarray(block, np.float32))
        if x.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got shape "
                f"{np.shape(block)}")
        if np.ndim(degrees) == 0:
            degs = np.full(self.channels, float(degrees), np.float32)
        else:
            degs = np.asarray(degrees, np.float32).reshape(self.channels)

        self._state, self._offset, out = advance_stream(
            self._state, self._cur_in, self._cur_out, self._offset,
            x, degs, self.geom, pipe=self._pipe)
        return out[0] if squeeze else out
