"""Wall ms of one dispatch step of the daemon's stream broker
(``StreamBroker._step``), at real-time pacing (layer stream broker)."""

from harness.readers import span_mean_ms


def read(trace):
    return span_mean_ms(trace, "broker_step")
