"""device.idle_pct.train (%): the share of the traced stretch (an epoch after
the window from the end of its first step to its end, started without a
synchronize) in which no kernel, copy or set ran on the card."""

from benchmark.harness.readers import idle_pct


def read(data):
    return idle_pct(data, "step_ms")
