"""Cross-session batched dispatch: N live sessions, ONE device step (torch).

Counterpart of ``phaserotate_tpu/stream/broker.py``.  The daemon hosts one
plugin instance per connection (bridge.py), and without batching each
instance costs its own device step per frame — N DAW sessions = N steps
per block period.  The broker is the serving-side fix: same-geometry
sessions share a K-slot stream engine, so every dispatch advances every
session with a frame pending — the inference-server dynamic-batching
pattern applied to the reference's hot path (src/phaserotate.c:538-772
served N-way).

Mechanics:

* Engine state is one :class:`~.engine.StreamState` with leading
  (capacity, channels) dims, on the broker's device; a per-slot
  ``active`` mask freezes the state of slots with nothing to process, and
  a ``reset`` mask zeroes a slot when a session (re)opens it — activate()
  semantics (src/phaserotate.c:511-520) inside the shared step.
* Dispatch is opportunistic: the first submitter becomes the dispatcher
  and drains the pending set; frames arriving while a dispatch is in
  flight coalesce into the next one, after a bounded hold for the other
  recently active slots.
* Output pipelining lives in the broker (depth ``D`` per slot): a submit
  returns the slot's output from ``D`` dispatches ago (zeros while
  filling).  On the card each dispatch starts one asynchronous copy of
  its output into a pinned host buffer and records an event; the buffer
  lives until every slot that rode that dispatch has popped it, so no
  submit waits on a copy that has not had ``D`` block periods to land —
  the contract of stream/host.OutputPipeline, shared across sessions.
* The frames, targets and masks of a dispatch go to the device as one
  snapshot: a buffer of their own (pinned on the card, copied without
  blocking), never the staging arrays the next dispatch rewrites.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.sizes import StreamGeometry
from .engine import StreamState, init_state, stream_step

__all__ = ["StreamBroker"]

_FIELDS = [f.name for f in dataclasses.fields(StreamState)]


def _slot_step(state: StreamState, frames: torch.Tensor,
               targets: torch.Tensor, active: torch.Tensor,
               reset: torch.Tensor, geom: StreamGeometry):
    """One masked step over (capacity, channels) slots.

    state: (K, C, ...) fields; frames (K, C, parsiz); targets (K, C)
    degrees; active (K,) bool; reset (K,) bool.
    """
    def mask(new, old, m):
        return torch.where(m.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                           old)

    # slot reset inside the step (activate() for a freshly opened slot)
    state = StreamState(**{
        f: mask(torch.zeros_like(getattr(state, f)), getattr(state, f),
                reset) for f in _FIELDS})
    new_state, y = stream_step(state, frames, targets, geom)
    out_state = StreamState(**{
        f: mask(getattr(new_state, f), getattr(state, f), active)
        for f in _FIELDS})
    return out_state, torch.where(active.reshape(-1, 1, 1), y, 0.0)


def _operands(flat: torch.Tensor, k: int, c: int, p: int):
    """(frames, targets, active, reset) of one dispatch from its packed
    operands: frames, then targets, then the two masks as 0/1."""
    n_fr, n_tg = k * c * p, k * c
    return (flat[:n_fr].view(k, c, p), flat[n_fr : n_fr + n_tg].view(k, c),
            flat[n_fr + n_tg : n_fr + n_tg + k] > 0.5,
            flat[n_fr + n_tg + k :] > 0.5)


class StreamBroker:
    """K-slot dynamic batcher for same-geometry streaming sessions.

    Thread-safe; every public method may be called from any session
    thread.  ``submit`` blocks until the (pipelined) output for the
    submitted frame's slot is available — one device dispatch serves
    every slot with a frame pending at dispatch time.  The engine runs on
    ``device`` (default: the CUDA device; ``"cpu"`` for the CPU).
    """

    def __init__(self, geom: StreamGeometry, channels: int,
                 capacity: int = 8, depth: int = 16,
                 hold_frac: float = 0.25, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.geom = geom
        self.channels = channels
        self.capacity = capacity
        self.depth = int(depth)
        self.device = resolve_device(device)
        # coalescing hold: free-running sessions do not align on their
        # own — without a hold the dispatcher drains singleton batches in
        # strict alternation.  Waiting up to this fraction of one frame
        # budget for the other open slots turns N near-simultaneous
        # submits into one dispatch; the cost is a bounded sub-frame
        # latency only when some open slot is idle.
        self.hold_s = float(hold_frac) * geom.parsiz / float(geom.rate)
        # a slot only counts toward the coalescing target while it is
        # actively submitting (last submit within ~2 frame periods): an
        # open-but-idle slot must not make every dispatch pay the full
        # hold waiting for a frame that is not coming
        self._active_window_s = 2.5 * geom.parsiz / float(geom.rate)
        self._last_seen = np.zeros(capacity, np.float64)
        self._state = init_state(geom, (capacity, channels), self.device)
        self._mu = threading.Lock()
        self._free: List[int] = list(range(capacity))
        self._reset_pending = np.zeros(capacity, bool)
        self._pending: Dict[int, Tuple[np.ndarray, np.ndarray, object]] \
            = {}
        self._dispatching = False
        self._cv = threading.Condition(self._mu)
        # per-slot in-flight outputs: deque of (host_batch, event, row)
        self._pipes: List[collections.deque] = [
            collections.deque() for _ in range(capacity)]
        # per-slot generation, bumped on open/reset/close: a dispatch
        # snapshot carries the generation it was taken under, so an
        # in-flight dispatch for a since-closed (possibly reopened) slot
        # cannot deposit a stale output into the new session's pipe —
        # without this, close+reopen during the device step shifts the
        # next session's whole stream by one frame
        self._slot_gen = [0] * capacity
        self._zeros = np.zeros((channels, geom.parsiz), np.float32)
        # reusable staging, rewritten every dispatch
        self._frames = np.zeros((capacity, channels, geom.parsiz),
                                np.float32)
        self._targets = np.zeros((capacity, channels), np.float32)
        self.dispatches = 0       # total device dispatches (telemetry)
        self.frames_served = 0    # total slot-frames served

    @property
    def extra_latency(self) -> int:
        """Samples of added latency from broker pipelining."""
        return self.depth * self.geom.parsiz

    def open(self) -> int:
        """Claim a slot (its state resets in the next dispatch)."""
        with self._mu:
            if not self._free:
                raise RuntimeError("stream broker full")
            slot = self._free.pop()
            self._reset_pending[slot] = True
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1
            return slot

    def close(self, slot: int) -> None:
        with self._mu:
            dropped = self._pending.pop(slot, None)
            if dropped is not None:  # never leave a submitter hanging
                done, box = dropped[2]
                box[0] = self._zeros
                done.set()
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1
            if slot not in self._free:
                self._free.append(slot)

    def reset(self, slot: int) -> None:
        """activate() for one slot: zero its engine state in the next
        dispatch and drop its in-flight outputs.  Call only from the
        slot's own session thread (no concurrent submit)."""
        with self._mu:
            self._reset_pending[slot] = True
            self._pipes[slot].clear()
            self._slot_gen[slot] += 1

    def in_use(self) -> int:
        with self._mu:
            return self.capacity - len(self._free)

    def submit(self, slot: int, frame: np.ndarray,
               degrees: np.ndarray) -> np.ndarray:
        """Advance ``slot`` by one (channels, parsiz) frame; returns the
        slot's output from ``depth`` dispatches ago (zeros until the
        pipeline fills).  Blocks until this frame's dispatch ran."""
        done = threading.Event()
        box: list = [None]
        self._last_seen[slot] = time.perf_counter()
        with self._mu:
            if slot in self._free:
                # a released slot may already belong to the NEXT
                # session: failing loudly here beats silently feeding
                # frames into someone else's stream
                raise RuntimeError(f"submit to unopened slot {slot}")
            if slot in self._pending:
                # a second frame before the first dispatched: wait our
                # turn (keeps per-slot ordering without queue growth)
                while slot in self._pending:
                    self._cv.wait()
            # np.array COPIES: the caller's staging buffer mutates while
            # this frame waits for (or rides) a dispatch
            self._pending[slot] = (np.array(frame, np.float32),
                                   np.array(degrees, np.float32),
                                   (done, box))
            self._cv.notify_all()  # a holding dispatcher may be waiting
            if self._dispatching:
                dispatcher = False
            else:
                self._dispatching = True
                dispatcher = True
        if dispatcher:
            self._drain()
        done.wait()
        return box[0]

    def _step(self, active: np.ndarray, reset: np.ndarray) -> torch.Tensor:
        """One masked step of every slot; returns its (K, C, parsiz) output.

        The frames, targets and masks go in as a snapshot of the staging:
        one array of their own (pinned on the card, copied without
        blocking; the pinned allocator keeps it until the copy is done),
        never the staging itself, which the next dispatch rewrites while
        this one may still be reading."""
        packed = torch.from_numpy(np.concatenate([
            self._frames.reshape(-1), self._targets.reshape(-1),
            active.astype(np.float32), reset.astype(np.float32)]))
        if self.device.type == "cuda":
            host = torch.empty(packed.shape, dtype=torch.float32,
                               pin_memory=True)
            packed = host.copy_(packed)
        self._state, y = _slot_step(
            self._state, *_operands(packed.to(self.device, non_blocking=True),
                                    *self._frames.shape), self.geom)
        return y

    @staticmethod
    def _start_readback(y: torch.Tensor):
        """(host batch, event): on the card an asynchronous copy into a
        pinned buffer and the event that marks it landed; a CPU result is
        already on the host."""
        if y.device.type != "cuda":
            return y, None
        host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        host.copy_(y, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record(torch.cuda.current_stream(y.device))
        return host, landed

    def _drain(self) -> None:
        while True:
            with self._mu:
                if not self._pending:
                    self._dispatching = False
                    self._cv.notify_all()
                    return
                # coalescing hold: give the other recently active slots a
                # bounded chance to land in this dispatch
                if self.hold_s > 0.0:
                    deadline = time.perf_counter() + self.hold_s

                    def want() -> int:
                        cutoff = (time.perf_counter()
                                  - self._active_window_s)
                        return int((self._last_seen > cutoff).sum())

                    while len(self._pending) < want():
                        left = deadline - time.perf_counter()
                        if left <= 0 or not self._cv.wait(timeout=left):
                            break
                batch = self._pending
                self._pending = {}
                gens = {slot: self._slot_gen[slot] for slot in batch}
                reset = self._reset_pending.copy()
                self._reset_pending[:] = False
                self._cv.notify_all()

            try:
                self._frames[:] = 0.0
                active = np.zeros(self.capacity, bool)
                for slot, (frame, degs, _w) in batch.items():
                    self._frames[slot] = frame
                    self._targets[slot] = degs
                    active[slot] = True
                host, landed = self._start_readback(
                    self._step(active, reset))
                self.dispatches += 1
                self.frames_served += len(batch)
                # delivery runs under the lock: the generation check and
                # the pipe append must be atomic against close()/reset(),
                # or a reopen landing between them still receives this
                # dead dispatch's output.  The device work is already
                # queued; the only thing inside the critical section that
                # can block is the pipeline-full wait on an event that had
                # `depth` block periods to land.
                with self._mu:
                    for slot, (_f, _d, (done, box)) in batch.items():
                        if self._slot_gen[slot] != gens[slot]:
                            # slot closed/reset (maybe reopened) while
                            # this dispatch was in flight: its output
                            # belongs to the dead session
                            box[0] = self._zeros
                            done.set()
                            continue
                        pipe = self._pipes[slot]
                        pipe.append((host, landed, slot))
                        if len(pipe) > self.depth:
                            old, old_landed, row = pipe.popleft()
                            if old_landed is not None:
                                old_landed.synchronize()
                            box[0] = old[row].numpy()
                        else:
                            box[0] = self._zeros
                        done.set()
            except BaseException:
                # a failed dispatch must not leave waiters blocked or the
                # broker claimed forever: release everyone — this batch's
                # waiters and any frames that queued into self._pending
                # while the dispatch was in flight (those submitters would
                # otherwise block in done.wait() until some unrelated
                # future submit became dispatcher) — clear the claim, and
                # surface the error
                for _slot, (_f, _d, (done, box)) in batch.items():
                    if box[0] is None:
                        box[0] = self._zeros
                    done.set()
                with self._mu:
                    stranded = self._pending
                    self._pending = {}
                    for _slot, (_f, _d, (done, box)) in stranded.items():
                        if box[0] is None:
                            box[0] = self._zeros
                        done.set()
                    self._dispatching = False
                    self._cv.notify_all()
                raise


def advance_stream_brokered(broker: StreamBroker, slot: int, cur_in,
                            cur_out, offset: int, x: np.ndarray,
                            degs: np.ndarray):
    """The host staging loop of stream/host.advance_stream with the frame
    step routed through a shared :class:`StreamBroker`.

    Same offset bookkeeping contract (src/phaserotate.c:615-725); the
    emitted output lags by ``broker.depth`` frames (broker pipelining).
    Returns ``(offset, out)`` — engine state lives in the broker.
    """
    parsiz = broker.geom.parsiz
    channels, n = x.shape
    out = np.empty_like(x)
    pos = 0
    while pos < n:
        ns = min(parsiz - offset, n - pos)
        cur_in[:, offset : offset + ns] = x[:, pos : pos + ns]
        out[:, pos : pos + ns] = cur_out[:, offset : offset + ns]
        offset += ns
        pos += ns
        if offset == parsiz:
            offset = 0
            # submit hands the broker its own snapshot (cur_in mutates
            # while the dispatch may still be in flight)
            cur_out[:] = broker.submit(slot, cur_in, degs)
    return offset, out
