"""Bytes the fleet shipped over the window as a share of the padded int16
batches it would ship as pcm16: the program's counters
``fleet.wire_bytes`` over ``fleet.pcm16_bytes`` (layer search packed)."""

from harness.program import counter_total


def read(trace):
    wire = counter_total(trace, "fleet.wire_bytes")
    pcm16 = counter_total(trace, "fleet.pcm16_bytes")
    if wire is None or not pcm16:
        return None
    return 100.0 * wire / pcm16
