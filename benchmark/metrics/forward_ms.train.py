"""Device milliseconds a step of ``Trainer.loss``: the task's forward and
loss in training mode."""

from benchmark.harness.readers import ms_per_call

SPANS = [("forward", "trainer", "loss")]


def read(reading):
    return ms_per_call(reading, "forward")
