"""Share of its bound that the Hilbert convolution at blksiz 32768 reaches
on the resident songs: the summed bounds of the window's
``hilbert.one_partition`` spans (``harness/roofline.py``
``conv_bound_ms(rows, n, n_out, 32768)`` from the span's attributes, the
same bound for the same work whatever computes it) over the device time
of the kernels whose name holds ``hilbert32k`` in the profiler's trace,
or where it holds none, over the spans' own device time (layer
kernels)."""

from harness.program import records
from harness.roofline import conv_bound_ms

FIR_TAPS = 32768


def read(trace):
    spans = [a for n, _, _, _, a in records(trace)[0]
             if n == "hilbert.one_partition"]
    if not spans:
        return None
    bound = sum(conv_bound_ms(a["rows"], a["n"], a["n_out"], FIR_TAPS)
                for a in spans)
    dev_ms = 0.0
    if trace.device:
        w0, w1 = trace.window
        dev_ms = sum((min(e, w1) - max(s, w0)) / 1e6
                     for n, s, e in trace.device
                     if "hilbert32k" in n and e > w0 and s < w1)
    if dev_ms <= 0.0:
        dev_ms = sum(a.get("device_ms", 0.0) for a in spans)
    if dev_ms <= 0.0:
        return None
    return 100.0 * bound / dev_ms
