"""Tensor ops of the port: the three hand-written kernels of the serving
path (merge_scan K1, attention K2, ln_gelu K3 forward; custom ops
``applecider_torch::seg_ids``, ``masked_attention`` and ``ln_gelu_fwd``)
with their plain PyTorch versions, plus conv1d and the top-k MoE dispatch."""
