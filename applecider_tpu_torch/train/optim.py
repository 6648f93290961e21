"""The optimizer's wrappers, EMA and the epoch-level schedulers of the
training loop (counterparts of ``applecider_tpu/train/optim.py`` and of the
optax wrappers the JAX ``Trainer`` composes).

The JAX Trainer's transformation is ``plateau_scale(MultiSteps(freeze(chain(
clip, task optimizer))))``: the clip sees the mean of the accumulated
gradients of the trainable parameters only, and the plateau scale
multiplies the emitted update. Here the pieces are applied in that order
around a ``torch.optim`` optimizer over the trainable parameters:
``GradAccumulator`` (``optax.MultiSteps``), ``clip_by_global_norm_``, the
optimizer's step with its learning rates scaled by ``ReduceLROnPlateau``'s
factor (``set_lr_scale``; for Adam and for AdamW's decoupled decay that is
optax's trailing ``scale(step_size)``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from applecider_tpu_torch.utils.observability import grad_norm


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Clip ``grads`` (f32) in place with optax's rule and return their
    global norm, sqrt(sum of squares over every gradient).

    ``optax.clip_by_global_norm``: unchanged when the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``. (``clip_grad_norm_``
    differs: it adds 1e-6 to the norm.) The choice is made on the device,
    so nothing is read back to the host.
    """
    norm = grad_norm(grads)
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(below, 1.0, torch.full_like(norm, max_norm)))
    return norm


def trainable_parameters(module: nn.Module, frozen_prefixes) -> list[tuple[str, nn.Parameter]]:
    """``module``'s named parameters outside the frozen subtrees.

    A name is frozen when it equals a prefix or starts with the prefix and a
    dot: ``trunk`` freezes ``trunk.*`` but not a sibling ``trunk_norm``
    (``freeze_subtrees``' segment-boundary match on flax paths). Frozen
    parameters keep ``requires_grad``: their gradients are computed, as
    JAX computes them before zeroing the frozen updates, so the attention
    keeps its training kernel and dropout (it routes by autograd)."""
    prefixes = tuple(str(p) for p in frozen_prefixes)
    return [(n, p) for n, p in module.named_parameters()
            if not any(n == pre or n.startswith(pre + ".") for pre in prefixes)]


class GradAccumulator:
    """``optax.MultiSteps(every_k_schedule=k)``: the running mean
    ``acc + (g - acc) / (i + 1)`` of k microbatches' gradients, emitted on
    every k-th microbatch (the optimizer steps then and on no other)."""

    def __init__(self, k: int):
        self.k = int(k)
        self.mini_step = 0
        self.acc: list[torch.Tensor] | None = None

    def add(self, grads: list[torch.Tensor]) -> list[torch.Tensor] | None:
        """Fold one microbatch's gradients in; the mean on the k-th, else None."""
        if self.acc is None:
            self.acc = [torch.zeros_like(g) for g in grads]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        self.mini_step += 1
        if self.mini_step < self.k:
            return None
        out, self.acc, self.mini_step = self.acc, None, 0
        return out

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.mini_step, self.acc = int(state["mini_step"]), state["acc"]


class EMA:
    """Exponential moving average of a module's parameters, by name:
    ``shadow * decay + param * (1 - decay)`` after every microbatch."""

    def __init__(self, decay: float = 0.999):
        self.decay = float(decay)
        self.shadow: dict[str, torch.Tensor] | None = None

    def init(self, module: nn.Module) -> None:
        self.shadow = {n: p.detach().clone() for n, p in module.named_parameters()}

    @torch.no_grad()
    def update(self, module: nn.Module) -> None:
        if self.shadow is None:
            self.init(module)
            return
        names = list(self.shadow)
        params = dict(module.named_parameters())
        shadow = [self.shadow[n] for n in names]
        torch._foreach_mul_(shadow, self.decay)
        torch._foreach_add_(shadow, [params[n].detach() for n in names], alpha=1.0 - self.decay)


@contextlib.contextmanager
def swapped_weights(module: nn.Module, state: dict[str, torch.Tensor]):
    """``module`` holds the parameters ``state`` (by name) inside the block
    and its own again after it."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        saved = {n: p.detach().clone() for n, p in params.items()}
        for n, p in params.items():
            p.copy_(state[n])
    try:
        yield module
    finally:
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(saved[n])


def set_lr_scale(optimizer: torch.optim.Optimizer, base_lrs: list[float], scale: float) -> None:
    """Each parameter group's learning rate = its base rate x ``scale``."""
    for group, lr in zip(optimizer.param_groups, base_lrs):
        group["lr"] = lr * scale


class ReduceLROnPlateau:
    """Host-side plateau tracker -> multiplicative LR scale (torch
    ``ReduceLROnPlateau.step(val_loss)`` semantics, reference
    ``core/trainer.py:233-238``)."""

    def __init__(self, factor: float = 0.5, patience: int = 5, min_scale: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_scale = min_scale
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best - 1e-12:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


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
