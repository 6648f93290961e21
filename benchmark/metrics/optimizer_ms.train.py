"""Device milliseconds a step of ``Trainer.apply_gradients``: the clip and
the optimizer's update (``train/optim.py``)."""

from benchmark.harness.readers import ms_per_call

SPANS = [("optimizer", "trainer", "apply_gradients")]


def read(reading):
    return ms_per_call(reading, "optimizer")
