"""Device milliseconds a batch of the spectra encoder (``models/spectranet.py``
on the compact spectra block, its ``ops/conv1d.py`` routes and K3f)."""

from benchmark.harness.readers import ms_per_call

SPANS = [("spectra", "model", "spectra_encoder.forward")]


def read(reading):
    return ms_per_call(reading, "spectra")
