"""Device milliseconds a step of the backward (``torch.autograd.backward``,
which ``loss.backward()`` in ``Trainer.train_step`` calls), the kernels
launched from autograd's thread included."""

from benchmark.harness.readers import ms_per_call

SPANS = [("backward", "module:torch.autograd", "backward")]


def read(reading):
    return ms_per_call(reading, "backward")
