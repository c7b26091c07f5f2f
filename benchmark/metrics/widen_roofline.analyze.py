"""Share of its bound that ``pcm24_widen`` reaches in the catalogue's
analysis: the summed bounds of the window's ``pcm24.widen`` spans, 3
bytes read and 4 written for each sample widened (the span's ``samples``,
all channels, zero padding included), over the device time of the
kernels named ``pcm24_widen`` in the profiler's trace, or where it holds
none, over the spans' own device time (layer kernels)."""

from harness.program import records
from harness.roofline import bound_ms

BYTES_PER_SAMPLE = 3 + 4


def read(trace):
    spans = [a for n, _, _, _, a in records(trace)[0] if n == "pcm24.widen"]
    if not spans:
        return None
    bound = sum(bound_ms(BYTES_PER_SAMPLE * a["samples"], 0.0)
                for a in spans)
    dev_ms = 0.0
    if trace.device:
        w0, w1 = trace.window
        dev_ms = sum((min(e, w1) - max(s, w0)) / 1e6
                     for n, s, e in trace.device
                     if "pcm24_widen" in n and e > w0 and s < w1)
    if dev_ms <= 0.0:
        dev_ms = sum(a.get("device_ms", 0.0) for a in spans)
    if dev_ms <= 0.0:
        return None
    return 100.0 * bound / dev_ms
