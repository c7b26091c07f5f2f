"""Wall ms the fleet's dispatch loop waits per batch for the staging
thread's decode and pack: the program's span ``fleet.stage_wait`` around
``fut.result()`` (layer fleet)."""

from harness.program import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "fleet.stage_wait")
