"""Arithmetic the per-layer metric readers share.  A reader that finds
nothing to read returns None, and the metric is left out of the line."""

from __future__ import annotations

from typing import Optional

from .trace import Trace, busy_seconds, window_seconds


def span_mean_ms(trace: Trace, name: str) -> Optional[float]:
    ds = [(e - s) / 1e6 for n, s, e in trace.spans if n == name]
    return sum(ds) / len(ds) if ds else None


def kernel_roofline(trace: Trace, kind: str, kernel: str) -> Optional[float]:
    """100 x the summed bounds of the window's ``kind`` calls over the
    device time of the kernels whose name holds ``kernel``: from the
    profiler's trace, or where it recorded none of them, from the CUDA
    events around each call."""
    calls = [c for c in trace.calls if c["kind"] == kind]
    if not calls:
        return None
    bound = sum(c["bound_ms"] for c in calls)
    dev_ms = 0.0
    if trace.device:
        w0, w1 = trace.window
        dev_ms = sum((min(e, w1) - max(s, w0)) / 1e6
                     for n, s, e in trace.device
                     if kernel in n and e > w0 and s < w1)
    if dev_ms <= 0.0:
        dev_ms = sum(c.get("event_ms", 0.0) for c in calls)
    if dev_ms <= 0.0:
        return None
    return 100.0 * bound / dev_ms


def idle_pct(trace: Trace) -> Optional[float]:
    if not trace.device or trace.window is None:
        return None
    return 100.0 * (1.0 - busy_seconds(trace) / window_seconds(trace))


def counter_ratio(trace: Trace, num: str, den: str) -> Optional[float]:
    d = trace.counters.get(den)
    if not d:
        return None
    return trace.counters.get(num, 0.0) / d
