"""Seeded randomness (counterpart of ``applecider_tpu/utils/rng.py``): one
root seed per run, split by purpose, and a seeded NumPy generator for the
host's work (oversampling maps, splits).

The JAX package threads ``jax.random`` keys; the port's counterparts are
``torch.Generator``s, or integer seeds, split from the root seed by NumPy's
``SeedSequence``, so the streams are independent and the same on every
machine.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


def seed_everything(seed: int) -> np.random.Generator:
    """Seed NumPy's and PyTorch's global generators (PyTorch's CPU and every
    card's) with ``seed``; returns a NumPy generator seeded with it."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def key_iter(seed: int, device: torch.device | str | None = None) -> Iterator:
    """An endless stream of independent integer seeds split from one root
    seed; with ``device``, ``torch.Generator``s on it seeded with them."""
    children = np.random.SeedSequence(int(seed))
    while True:
        (child,) = children.spawn(1)
        sub = int(child.generate_state(1, np.uint64)[0] >> np.uint64(1))  # < 2**63
        yield sub if device is None else torch.Generator(device=device).manual_seed(sub)
