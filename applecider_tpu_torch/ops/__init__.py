"""Tensor ops of the port: the three hand-written kernels of the serving
path (merge_scan K1, attention K2, ln_gelu K3 forward; custom ops
``applecider_torch::seg_ids``, ``masked_attention`` and ``ln_gelu_fwd``)
with their plain PyTorch versions, plus conv1d and the top-k MoE dispatch."""

from applecider_tpu_torch._lazy import lazy_names

# the JAX package's public names of this package, imported at first use
_NAMES = {
    "class_balanced_weights": ("applecider_tpu_torch.ops.losses", "class_balanced_weights"),
    "cross_entropy": ("applecider_tpu_torch.ops.losses", "cross_entropy"),
    "dice_loss": ("applecider_tpu_torch.ops.losses", "dice_loss"),
    "focal_loss": ("applecider_tpu_torch.ops.losses", "focal_loss"),
    "multiclass_bce_loss": ("applecider_tpu_torch.ops.losses", "multiclass_bce_loss"),
    "topk_dense_dispatch": ("applecider_tpu_torch.ops.moe", "topk_dense_dispatch"),
}
__all__ = [*_NAMES]
__getattr__, __dir__ = lazy_names(__name__, _NAMES, globals())
