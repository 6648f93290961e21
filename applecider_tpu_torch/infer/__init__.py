"""Serving path of the port."""

from applecider_tpu_torch.infer.stream import (
    AlertStreamPipeline, FusedSpectraStream, LengthBinnedFeeder, pack_alert_batch,
)

__all__ = ["AlertStreamPipeline", "FusedSpectraStream", "LengthBinnedFeeder", "pack_alert_batch"]
