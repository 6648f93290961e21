"""Host milliseconds a batch spends in ``infer.stream.pack_compact``, the
host half of ``FusedSpectraStream.place``."""

from benchmark.harness.readers import ms_per_call

SPANS = [("pack", "module:applecider_tpu_torch.infer.stream", "pack_compact")]


def read(reading):
    return ms_per_call(reading, "pack", "host_s")
