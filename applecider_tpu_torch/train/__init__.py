"""Training of the port: the optimizer pieces and the Trainer."""

from applecider_tpu_torch._lazy import lazy_names

# the JAX package's public names of this package, imported at first use
_NAMES = {
    "Trainer": ("applecider_tpu_torch.train.trainer", "Trainer"),
    "AppleCiderRuntime": ("applecider_tpu_torch.train.runtime", "AppleCiderRuntime"),
}
__all__ = [*_NAMES]
__getattr__, __dir__ = lazy_names(__name__, _NAMES, globals())
