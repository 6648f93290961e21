"""Models of the port: the AppleCider fusion model and its encoders."""

from applecider_tpu_torch.models.fusion import AppleCiderModule, build_fusion_model

__all__ = ["AppleCiderModule", "build_fusion_model"]
