"""PyTorch/CUDA port of AppleCider-TPU for NVIDIA Hopper (H100).

A second package beside ``applecider_tpu`` (the JAX reference, which it
never imports). Module names mirror the reference: ``ops`` (the hand-written
CUDA kernels and their plain PyTorch versions), ``models`` (the AppleCider
fusion model), ``infer`` (the alert-stream serving path), ``utils.weights``
(carrying JAX parameters over).

Entry points run on CUDA by default and on the CPU only when called with
``device="cpu"``.
"""

from applecider_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
