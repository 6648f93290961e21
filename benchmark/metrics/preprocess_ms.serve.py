"""Device milliseconds a batch of ``ServingProgram.preprocess``: the K1
merge, featurisation, spectrum resampling and MAD."""

from benchmark.harness.readers import ms_per_call

SPANS = [("preprocess", "program", "preprocess")]


def read(reading):
    return ms_per_call(reading, "preprocess")
