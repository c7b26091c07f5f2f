"""Device ms of the widening of a 24-bit batch on the card: the CUDA
events of the program's span ``pcm24.widen`` around ``pcm24_widen`` in
``sweep_peaks_aux_pcm24`` (layer search)."""

from harness.program import device_mean_ms


def read(trace):
    return device_mean_ms(trace, "pcm24.widen")
