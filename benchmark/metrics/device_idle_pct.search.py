"""Share of the traced window in which no kernel or copy ran on the card,
over the resident songs' search (layer device)."""

from harness.readers import idle_pct


def read(trace):
    return idle_pct(trace)
