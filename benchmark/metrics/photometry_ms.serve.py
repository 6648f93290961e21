"""Device milliseconds a batch of the photometry encoder
(``models/baseline_cls.py``)."""

from benchmark.harness.readers import ms_per_call

SPANS = [("photometry", "model", "photometry_encoder.forward")]


def read(reading):
    return ms_per_call(reading, "photometry")
