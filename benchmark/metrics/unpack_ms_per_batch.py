"""Device ms of the packed wire's unpack per packed batch: the CUDA
events of the program's span ``packed.unpack`` around ``unpack_residual``
(layer search packed)."""

from harness.program import device_mean_ms


def read(trace):
    return device_mean_ms(trace, "packed.unpack")
