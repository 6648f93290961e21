"""Gradient clipping, the optimizer and early stopping of the training step
(counterparts of ``with_grad_clip``, ``AppleCiderTask.make_optimizer`` and
``EarlyStopping`` in the JAX package's ``train/optim.py`` and
``models/fusion.py``)."""

from __future__ import annotations

from typing import Iterable

import torch


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip ``grads`` (f32) in place with optax's rule and return their
    global norm, sqrt(sum of squares over every gradient).

    ``optax.clip_by_global_norm``: unchanged when the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``. (``clip_grad_norm_``
    differs: it adds 1e-6 to the norm.) The choice is made on the device,
    so nothing is read back to the host.
    """
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(below, 1.0, torch.full_like(norm, max_norm)))
    return norm


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root (optax's eps_root 0), no weight decay; torch's Adam is the
    same update."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)


class EarlyStopping:
    """Patience-based early stop on a lower-is-better metric."""

    def __init__(self, patience: int = 15):
        self.patience = patience
        self.best = None
        self.counter = 0

    def step(self, metric: float) -> bool:
        if self.best is None or metric < self.best:
            self.best = metric
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience
