"""Share of its bound that the sweep kernel reaches on the resident songs:
the summed bounds of the window's calls of ``rotate_peak_sweep_kernel``
over the device time of ``sweep_kernel`` (layer kernels)."""

from harness.readers import kernel_roofline


def read(trace):
    return kernel_roofline(trace, "sweep", "sweep_kernel")
