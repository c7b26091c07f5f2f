"""Wall ms of the host's angle selection per batch of resident songs: the
program's span ``search.select`` around ``select_min_peak_angles_batch``
(layer search)."""

from harness.program import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "search.select")
