"""The share of the traced window in which no kernel, copy or fill ran on
the card, in %: one minus the union of the device's intervals over the
window."""

from benchmark.harness.readers import idle_share


def read(reading):
    return idle_share(reading)
