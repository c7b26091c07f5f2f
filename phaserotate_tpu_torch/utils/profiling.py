"""Tracing / profiling hooks (torch).

Counterpart of ``phaserotate_tpu/utils/profiling.py``: a
``torch.profiler`` trace capture around any stage, and a lightweight
wall-clock stage timer.  CUDA work is asynchronous, so a timed stage ends
on :func:`sync` of what it produced.

The port's own recorder lives here too: :func:`span` and :func:`count`,
placed at the layers where the work happens (``fleet.*``,
``packed.unpack``, ``search.select``).  They record only while a
``torch.profiler`` session runs or a :func:`recording` scope is open; off,
a span is one shared null context and costs two attribute reads.  Spans
take both ends from ``time.time_ns()``, the wall clock that the profiler's
Chrome trace also carries (``ts`` plus ``baseTimeNanoseconds``), so spans
and kernels lie on one time line; each span also enters
``torch.profiler.record_function`` and so shows by name in a profiler
trace (a session hears it only from the thread that started it unless the
session profiles all threads, as :func:`device_trace` does).
:func:`drain` hands the records over and empties the buffer.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Union

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["CountRecord", "RECORDS_MAX", "SpanRecord", "StageTimer",
           "count", "device_trace", "drain", "recording", "span", "sync"]

# The buffer keeps the newest records up to this many; a reader that
# drains once per traced window never comes near it.
RECORDS_MAX = 1 << 20


class SpanRecord(NamedTuple):
    """One span: wall-clock ends in ns and the span's attributes (after
    :func:`drain`, ``device_ms`` for a span opened with ``device``)."""

    name: str
    thread: str
    t0_ns: int
    t1_ns: int
    attrs: dict


class CountRecord(NamedTuple):
    """One counter increment ``n`` at wall-clock ``t_ns``."""

    name: str
    t_ns: int
    n: int


_records: collections.deque = collections.deque(maxlen=RECORDS_MAX)
_recording = 0  # open recording() scopes, across threads
_recording_lock = threading.Lock()


class _Off:
    """The span handed out while nothing records: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "_stream", "_events", "_fn", "_t0")

    def __init__(self, name: str, stream, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._stream = stream

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        # named in the profiler's trace where a session runs
        self._fn = None
        if _autograd_profiler._is_profiler_enabled:
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
        self._events = None
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self._t0 = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
            self.attrs["_events"] = self._events + (self._stream.device,)
        if self._fn is not None:
            self._fn.__exit__(exc_type, exc, tb)
        _records.append(SpanRecord(self.name, threading.current_thread().name,
                                   self._t0, t1, self.attrs))
        return False


def _stream_of(device):
    if device is True:
        return torch.cuda.current_stream()
    if not device:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def span(name: str, device: Union[bool, str, torch.device] = False, **attrs):
    """A context manager that records ``name`` over its scope, with
    ``attrs`` (more through ``.set(**attrs)`` inside the scope).

    ``device``: True, or a CUDA device, also records a pair of CUDA events
    on that device's current stream (no synchronize); :func:`drain` turns
    them into ``attrs["device_ms"]``.  A CPU device records none.
    Records nothing, and returns one shared null context, unless a
    ``torch.profiler`` session runs or a :func:`recording` scope is open.
    """
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, _stream_of(device), attrs)


def count(name: str, n: int) -> None:
    """Record that counter ``name`` grew by ``n`` (only while recording,
    as :func:`span`)."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        _records.append(CountRecord(name, time.time_ns(), n))


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters over the scope, with or without a
    profiler session (scopes nest and may overlap across threads)."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def drain() -> List[Union[SpanRecord, CountRecord]]:
    """The records so far, oldest first; the buffer is left empty.  Spans
    opened with ``device`` get ``attrs["device_ms"]`` here, after one
    ``torch.cuda.synchronize`` of each device their events were recorded
    on."""
    out: List[Union[SpanRecord, CountRecord]] = []
    while True:
        try:
            out.append(_records.popleft())
        except IndexError:
            break
    timed = [r.attrs for r in out
             if isinstance(r, SpanRecord) and "_events" in r.attrs]
    for device in {attrs["_events"][2] for attrs in timed}:
        torch.cuda.synchronize(device)
    for attrs in timed:
        start, end, _ = attrs.pop("_events")
        attrs["device_ms"] = start.elapsed_time(end)
    return out


def sync(*tensors) -> None:
    """Barrier: wait for the device of every CUDA tensor given (nothing
    to wait for on the CPU)."""
    devices = {t.device for t in tensors
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulating per-stage wall-clock timer.

    Example::

        t = StageTimer()
        with t.stage("hilbert"):
            h = hilbert_offline(x, geom); sync(h)
        print(t.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            c = self.counts[name]
            lines.append(f"{name:24s} {t * 1e3:9.2f} ms  ({c}x, "
                         f"{t / c * 1e3:.2f} ms avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the scope (CPU activity, and
    CUDA activity where a card is present) and write it into ``log_dir``
    as a Chrome trace, ``trace_<pid>_<ns>.json`` (chrome://tracing,
    Perfetto).  The port's spans and counters record over the scope; the
    spans show in the trace by name, those of every thread (the profiler
    hears ``record_function`` from all threads, not only this one: the
    fleet's staging thread too)."""
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=_ExperimentalConfig(profile_all_threads=True))
    with recording():
        prof.start()
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
