"""Wall ms of ``search.packed.pack_adaptive`` per batch, on the fleet's
staging thread (layer search packed)."""

from harness.readers import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "pack")
