"""Utilities of the port."""

from applecider_tpu_torch._lazy import lazy_names

# the JAX package's public names of this package, imported at first use
_NAMES = {
    "seed_everything": ("applecider_tpu_torch.utils.rng", "seed_everything"),
    "key_iter": ("applecider_tpu_torch.utils.rng", "key_iter"),
}
__all__ = [*_NAMES]
__getattr__, __dir__ = lazy_names(__name__, _NAMES, globals())
