"""PyTorch/CUDA port of AppleCider-TPU for NVIDIA Hopper (H100).

A second package beside ``applecider_tpu`` (the JAX reference, which it
never imports). Module names mirror the reference: ``ops`` (the hand-written
CUDA kernels and their plain PyTorch versions), ``models`` (the AppleCider
fusion model), ``infer`` (the alert-stream serving path), ``utils.weights``
(carrying JAX parameters over).

Entry points run on CUDA by default and on the CPU only when called with
``device="cpu"``.
"""

from applecider_tpu_torch._lazy import lazy_names
from applecider_tpu_torch.device import resolve_device

__version__ = "0.1.0"

# the JAX package's public names of this package, imported at first use
_NAMES = {
    "Config": ("applecider_tpu_torch.config", "Config"),
    "load_config": ("applecider_tpu_torch.config", "load_config"),
    "get_model": ("applecider_tpu_torch.registry", "get_model"),
    "get_dataset_class": ("applecider_tpu_torch.registry", "get_dataset_class"),
    "register_model": ("applecider_tpu_torch.registry", "register_model"),
    "register_dataset": ("applecider_tpu_torch.registry", "register_dataset"),
}
__all__ = ["resolve_device", *_NAMES]
__getattr__, __dir__ = lazy_names(__name__, _NAMES, globals())
