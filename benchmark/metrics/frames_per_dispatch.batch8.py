"""Session frames carried per broker dispatch over the traced window, from
the broker's own counters ``frames_served`` and ``dispatches`` (layer
stream broker)."""

from harness.readers import counter_ratio


def read(trace):
    return counter_ratio(trace, "frames_served", "dispatches")
