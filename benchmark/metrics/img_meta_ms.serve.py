"""Device milliseconds a batch of the image and metadata encoder
(``models/astrominn.py`` and its ConvNeXt)."""

from benchmark.harness.readers import ms_per_call

SPANS = [("img_meta", "model", "img_meta_encoder.forward")]


def read(reading):
    return ms_per_call(reading, "img_meta")
