"""Dropout with the JAX package's 8-bit threshold rule, and the generators
that feed every dropout site of a model.

Counterpart of ``applecider_tpu/ops/dropout.py``. ``FastDropout(rate)``
draws u8 bits, keeps an element iff its bits are >= ``thresh =
round(rate * 256)`` and scales kept elements by ``256 / (256 - thresh)``,
computed from the integer threshold so the estimator is exactly unbiased
for the realised rate. It is the identity in eval mode or when ``thresh``
is 0, and returns zeros when ``thresh`` rounds to 256. Not a Pallas kernel
in the JAX package, so plain PyTorch here.

``DropoutRNG`` holds the two generators of a training run: a CPU generator
that hands each K4 attention call its Philox seed as a host integer (no
read-back from the card), and a generator on the model's device for the
``FastDropout`` bits. ``attach_dropout_rng`` points every dropout site of a
model at one; a site without one draws from PyTorch's default generators.
"""

from __future__ import annotations

import torch
from torch import nn

SEED_BOUND = 2**31 - 1  # K4 seeds are drawn in [0, int32 max), as the JAX package draws them


class DropoutRNG:
    """CPU generator for K4 seeds and a device generator for dropout bits,
    both seeded from ``seed``."""

    def __init__(self, seed: int, device: torch.device | str = "cpu"):
        self.cpu = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def attach_dropout_rng(model: nn.Module, rng: DropoutRNG | None) -> None:
    """Every submodule with a ``dropout_rng`` attribute draws from ``rng``."""
    for m in model.modules():
        if hasattr(m, "dropout_rng"):
            m.dropout_rng = rng


def drop_consts(rate: float) -> tuple[int, float]:
    """(integer threshold, inverted keep scale) of the 8-bit rule."""
    thresh = int(round(float(rate) * 256.0))
    return thresh, (256.0 / (256 - thresh) if thresh < 256 else 0.0)


class FastDropout(nn.Module):
    """``nn.Dropout(rate)`` with the 8-bit threshold rule; active in
    ``train()`` mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.dropout_rng: DropoutRNG | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        thresh, scale = drop_consts(self.rate)
        if not self.training or thresh == 0:
            return x
        if thresh >= 256:
            return torch.zeros_like(x)
        gen = None if self.dropout_rng is None else self.dropout_rng.device
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=gen)
        # the scale rounded to x's dtype first, as the JAX package multiplies
        # by jnp.asarray(scale, x.dtype)
        s = float(torch.tensor(scale, dtype=x.dtype))
        return torch.where(bits >= thresh, x * s, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
