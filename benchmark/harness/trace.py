"""Spans around the calls into the program's layers, and the device trace.

A traced run installs wrappers on the program's module attributes: each
records a span (name, start, end on the wall clock in ns), and those
around a kernel's entry also the call's shapes and the least time its
work can take (``roofline.py``).  The device's kernels and copies come
from ``torch.profiler`` (CUDA activity only, so the host's torch calls are
not slowed by recording).  Its Chrome trace carries the wall clock
(``ts`` in us from ``baseTimeNanoseconds``), so spans and device
intervals share one time line; an idle stretch of the card is named
after the span that covers most of it."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """What one traced window recorded."""

    spans: List[Tuple[str, int, int]] = dataclasses.field(
        default_factory=list)
    calls: List[dict] = dataclasses.field(default_factory=list)
    device: Optional[List[Tuple[str, int, int]]] = None
    window: Optional[Tuple[int, int]] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "Trace":
        t = cls(**d)
        t.spans = [tuple(s) for s in t.spans]
        if t.device is not None:
            t.device = [tuple(e) for e in t.device]
        if t.window is not None:
            t.window = tuple(t.window)
        return t


class Patches:
    """Attribute patches that ``restore`` undoes in reverse order."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def set(self, obj, attr: str, value) -> None:
        self._saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def restore(self) -> None:
        while self._saved:
            obj, attr, old = self._saved.pop()
            setattr(obj, attr, old)


def span_wrapper(fn: Callable, name: str, trace: Trace,
                 on_call: Optional[Callable] = None) -> Callable:
    """``fn`` recording a span per call; ``on_call(args, kwargs, result,
    start_event, end_event)`` adds a call record."""

    def wrapped(*args, **kwargs):
        t0 = time.time_ns()
        events = None
        if on_call is not None:
            import torch

            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        try:
            out = fn(*args, **kwargs)
        finally:
            trace.spans.append((name, t0, time.time_ns()))
        if on_call is not None:
            events[1].record()
            on_call(args, kwargs, out, events)
        return out

    return wrapped


class DeviceTrace:
    """``torch.profiler`` over one window; ``stop`` returns the device's
    kernels and copies as (name, start ns, end ns)."""

    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.prof = None
        self.t0 = self.t1 = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.time_ns()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.stop()
        path = os.path.join(self.tmpdir, "device_trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        os.unlink(path)
        base = int(data.get("baseTimeNanoseconds", 0))
        events = []
        for e in data.get("traceEvents", []):
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                s = int(round(float(e["ts"]) * 1e3)) + base
                events.append((e["name"], s, s + int(round(
                    float(e["dur"]) * 1e3))))
        self.prof = None
        return events, (self.t0, self.t1)


def busy_intervals(trace: Trace) -> List[Tuple[int, int]]:
    """The device's busy stretches inside the window, merged."""
    w0, w1 = trace.window
    iv = sorted((max(s, w0), min(e, w1)) for _, s, e in trace.device
                if e > w0 and s < w1)
    merged: List[List[int]] = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_seconds(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e9


def window_seconds(trace: Trace) -> float:
    return (trace.window[1] - trace.window[0]) / 1e9


def _label(spans, s: int, e: int) -> str:
    cover: Dict[str, int] = {}
    for name, a, b in spans:
        o = min(b, e) - max(a, s)
        if o > 0:
            cover[name] = cover.get(name, 0) + o
    if not cover:
        return "no span"
    return max(cover.items(), key=lambda kv: kv[1])[0]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    stretches named by the span that covers most of each."""
    w0, w1 = trace.window
    by_op: Dict[str, float] = {}
    for name, s, e in trace.device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            key = name[:120]
            by_op[key] = by_op.get(key, 0.0) + (e - s) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = w0
    for s, e in busy_intervals(trace) + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(trace.spans, s, e), (e - s) / 1e9] for s, e in gaps[:top]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
