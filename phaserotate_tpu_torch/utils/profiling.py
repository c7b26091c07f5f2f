"""Tracing / profiling hooks (torch).

Counterpart of ``phaserotate_tpu/utils/profiling.py``: a
``torch.profiler`` trace capture around any stage, and a lightweight
wall-clock stage timer.  CUDA work is asynchronous, so a timed stage ends
on :func:`sync` of what it produced.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch

__all__ = ["StageTimer", "device_trace", "sync"]


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
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
