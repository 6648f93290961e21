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
``FastDropout`` bits. ``stream`` (a rank's data index) folds into the seed,
so each rank of a data-parallel run draws its own bits, K4 seeds and MPT
mask for its rows; stream 0 is the seed itself. ``attach_dropout_rng`` points every dropout site of a
model at one; a site without one draws from PyTorch's default generators.

``checkpoint(fn, *args, rngs=...)`` runs ``fn`` under PyTorch's
non-reentrant activation checkpoint with its draws replayed: the backward
recomputes the region from the state every generator had when the region
was entered, so the recompute draws the K4 seeds, the dropout bits and
MPT's mask the first pass drew. ``preserve_rng_state`` replays PyTorch's
default generators; ``replay_context_fn`` replays the ``DropoutRNG``s, which
are not default generators. After the recompute every generator is back
where the recompute found it, so a checkpointed step leaves the run's
generators exactly where a plain step leaves them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

SEED_BOUND = 2**31 - 1  # K4 seeds are drawn in [0, int32 max), as the JAX package draws them


class DropoutRNG:
    """CPU generator for K4 seeds and a device generator for dropout bits,
    both seeded from ``seed`` and ``stream``."""

    def __init__(self, seed: int, device: torch.device | str = "cpu", stream: int = 0):
        if stream:
            seed = int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1)[0])
        self.cpu = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=torch.device(device)).manual_seed(int(seed))

    def get_state(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The states of both generators (CPU byte tensors)."""
        return self.cpu.get_state(), self.device.get_state()

    def set_state(self, state: tuple[torch.Tensor, torch.Tensor]) -> None:
        self.cpu.set_state(state[0])
        self.device.set_state(state[1])


def attach_dropout_rng(model: nn.Module, rng: DropoutRNG | None) -> None:
    """Every submodule with a ``dropout_rng`` attribute draws from ``rng``."""
    for m in model.modules():
        if hasattr(m, "dropout_rng"):
            m.dropout_rng = rng


def dropout_rngs(model: nn.Module) -> list[DropoutRNG]:
    """The distinct ``DropoutRNG``s that ``model``'s submodules draw from."""
    found: dict[int, DropoutRNG] = {}
    for m in model.modules():
        rng = getattr(m, "dropout_rng", None)
        if rng is not None:
            found.setdefault(id(rng), rng)
    return list(found.values())


def replay_context_fn(rngs: Sequence[DropoutRNG]) -> Callable:
    """A ``context_fn`` for ``torch.utils.checkpoint.checkpoint``: the
    forward context records each generator's state on entering the region;
    the recompute context sets them back to it, and on exit, also an early
    stop of the recompute, puts back the state it found."""

    def context_fn():
        entered: list = []

        @contextlib.contextmanager
        def forward():
            entered[:] = [r.get_state() for r in rngs]
            yield

        @contextlib.contextmanager
        def recompute():
            found = [r.get_state() for r in rngs]
            for r, s in zip(rngs, entered):
                r.set_state(s)
            try:
                yield
            finally:
                for r, s in zip(rngs, found):
                    r.set_state(s)

        return forward(), recompute()

    return context_fn


def checkpoint(fn: Callable, *args, rngs: Sequence[DropoutRNG] = ()):
    """``fn(*args)`` under a non-reentrant activation checkpoint whose
    recompute replays the default generators and ``rngs``.

    Non-reentrant, because the reentrant form runs the first pass without
    autograd, where the attention would take K2, the serving kernel, with
    no dropout: the training forward would change without an error."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=True,
        context_fn=replay_context_fn(list(rngs)))


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
