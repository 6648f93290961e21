"""The task contract of the port's ``Trainer`` (counterpart of
``applecider_tpu/models/base.py``): an ``nn.Module`` bundled with its loss,
its optimizer and its host-side batch conversion.

A task holds ``self.module``; ``Trainer`` moves it to its device, points its
dropout sites at the run's generators and calls:

* ``loss(batch, train, kernels)`` -> ``(loss, {"metrics": {...}, "logits"?})``
  on device tensors; ``train`` puts the module in train mode (dropout live),
  as the JAX ``loss_fn``'s ``train`` flag makes it non-deterministic; a task
  without ``logits`` (MPT) is evaluated on its loss alone;
* ``predict(batch, kernels)``: the module in eval mode;
* ``make_optimizer(params)``: a ``torch.optim`` optimizer over the trainable
  parameters, ``grad_clip`` the global-norm clip in front of it (None: off);
* ``to_tensor(host_batch)``: a collated batch as NumPy arrays, labels last;
* ``init(batch)``: the JAX task's ``init(rng, batch)``, called on the first
  ``to_tensor`` batch before a ``Trainer`` takes the task. A task whose
  model is sized by its inputs (the zoo's, ``models/zoo.py``) builds it
  there; every other task builds its model in its constructor and does
  nothing.

``kernels=False`` selects the plain PyTorch versions of the kernels on the
card (the yardstick), as the models' ``forward`` does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.config import Config, compute_dtype


class Task:
    name: str = "task"
    grad_clip: float | None = None
    module: nn.Module

    def __init__(self, cfg: Config):
        self.cfg = cfg

    def init(self, batch: tuple[np.ndarray, ...]) -> None:
        """Size the model from a host batch; a no-op for a task built whole."""

    def loss(self, batch: tuple[torch.Tensor, ...], train: bool = True, kernels: bool = True
             ) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def predict(self, batch: tuple[torch.Tensor, ...], kernels: bool = True) -> torch.Tensor:
        raise NotImplementedError

    def make_optimizer(self, params: list[nn.Parameter]) -> torch.optim.Optimizer:
        raise NotImplementedError

    @staticmethod
    def to_tensor(data_dict: dict) -> tuple[np.ndarray, ...]:
        raise NotImplementedError

    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg)


def maybe_softmax(logits: torch.Tensor, use_probabilities: bool) -> torch.Tensor:
    """The softmax of ``logits`` in f32 when ``use_probabilities``, else the
    logits."""
    return torch.softmax(logits.float(), dim=-1) if use_probabilities else logits


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 added outside the
    square root (optax's eps_root 0), no weight decay; torch's Adam is the
    same update."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)


def adamw(params, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8
          ) -> torch.optim.AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)``: the decay is
    decoupled from the moments in both (``p -= lr * (update + wd * p)`` in
    optax, ``p *= 1 - lr * wd`` then the Adam step in torch, each reading
    the old ``p``), on every parameter, so torch's AdamW is the same update
    up to rounding. ``params`` may be a list of param-group dicts."""
    return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay, foreach=True)
