"""Device ms of the Hilbert convolution of a batch at blksiz 32768: the
CUDA events of the program's span ``hilbert.one_partition`` around
``hilbert_32k`` in ``search.sweep.hilbert_offline`` (layer search)."""

from harness.program import device_mean_ms


def read(trace):
    return device_mean_ms(trace, "hilbert.one_partition")
