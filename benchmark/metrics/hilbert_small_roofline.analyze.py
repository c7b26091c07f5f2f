"""Share of its bound that ``hilbert_small`` reaches in the catalogue's
analysis: the summed bounds of the window's calls over the device time
of stream_conv's ``stream_runs`` kernel in conv mode (layer kernels)."""

from harness.readers import kernel_roofline


def read(trace):
    return kernel_roofline(trace, "hilbert", "stream_runs")
