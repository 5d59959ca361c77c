"""device.idle_pct.predict (%): the share of the traced stretch (three batch
intervals in the middle of a pass after the window, started without a
synchronize) in which no kernel, copy or set ran on the card."""

from benchmark.harness.readers import idle_pct


def read(data):
    return idle_pct(data, "batch_times")
