"""The program's own spans and counters over a traced window.

The port records them itself where the work happens
(``phaserotate_tpu_torch.utils.profiling``: ``span`` and ``count``, named
``fleet.stage_wait``, ``packed.unpack``, ``search.select`` and so on)
whenever a ``torch.profiler`` session runs; a traced CUDA run holds one
over exactly its window (``trace.DeviceTrace``), so the benchmark needs no
switch.  The recorder is drained once per :class:`~harness.trace.Trace`,
on the first reader's call after the window, and the records inside the
window are kept: spans as (name, thread, start ns, end ns, attributes),
counters as (name, ns, n), on the wall clock of the trace's own spans and
device intervals.  A program without the recorder gives no records, and
each reader of them finds nothing."""

from __future__ import annotations

from typing import List, Optional, Tuple


def _drain() -> list:
    from phaserotate_tpu_torch.utils import profiling

    drain = getattr(profiling, "drain", None)
    return list(drain()) if drain is not None else []


def records(trace) -> Tuple[List[tuple], List[tuple]]:
    """(spans, counters) the program recorded inside ``trace.window``."""
    got = trace.__dict__.get("program_records")
    if got is None:
        got = _inside(trace.window, _drain())
        trace.__dict__["program_records"] = got  # not a field: not in JSON
    return got


def _inside(window, recs) -> Tuple[List[tuple], List[tuple]]:
    """Split ``recs`` into spans and counters, keeping those that lie
    wholly inside ``window`` (none without a window)."""
    spans: List[tuple] = []
    counters: List[tuple] = []
    if window is None:
        return spans, counters
    w0, w1 = window
    for r in recs:
        if len(r) == 5 and w0 <= r[2] and r[3] <= w1:
            spans.append(tuple(r))
        elif len(r) == 3 and w0 <= r[1] <= w1:
            counters.append(tuple(r))
    return spans, counters


def span_mean_ms(trace, name: str) -> Optional[float]:
    """Mean wall ms of the program's spans called ``name``."""
    ds = [(t1 - t0) / 1e6 for n, _, t0, t1, _ in records(trace)[0]
          if n == name]
    return sum(ds) / len(ds) if ds else None


def device_mean_ms(trace, name: str) -> Optional[float]:
    """Mean device ms (CUDA events) of the program's spans called
    ``name``."""
    ds = [a["device_ms"] for n, _, _, _, a in records(trace)[0]
          if n == name and "device_ms" in a]
    return sum(ds) / len(ds) if ds else None


def counter_total(trace, name: str) -> Optional[int]:
    """Sum of the program's counter ``name`` (None if never counted)."""
    ns = [n for c, _, n in records(trace)[1] if c == name]
    return sum(ns) if ns else None
