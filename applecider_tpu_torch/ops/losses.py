"""The two training criteria of the AppleCider fusion task (counterpart of
``cross_entropy`` and ``focal_loss`` in ``applecider_tpu/ops/losses.py``).

Both take logits (B, C) and integer labels (B,), compute in f32 and reduce
with ``mean`` by default, as the torch losses the reference trains with.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
               alpha: torch.Tensor | None = None, eps: float = 0.0,
               reduction: str = "mean") -> torch.Tensor:
    """Multi-class focal loss ``-(y * (1 - p)^gamma * log p).sum(-1)``;
    ``eps > 0`` smooths the labels with mass ``eps / (C - 1)`` off target."""
    logp = F.log_softmax(logits.float(), dim=-1)
    p = torch.exp(logp)
    C = logp.shape[-1]
    if eps > 0:
        y = torch.full_like(logp, eps / (C - 1))
        y[torch.arange(labels.shape[0], device=labels.device), labels] = 1.0 - eps
    else:
        y = F.one_hot(labels, C).float()
    weight = (1.0 - p) ** gamma
    if alpha is not None:
        weight = weight * alpha.reshape(1, C)
    return _reduce(-torch.sum(y * weight * logp, dim=-1), reduction)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor | None = None,
                  reduction: str = "mean") -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss`` semantics. Floating ``labels`` of the
    logits' rank are a (soft) target distribution: per-sample loss
    ``-sum_c w_c y_c log p_c`` and a plain batch mean. Integer labels use
    the weight-normalised mean."""
    logp = F.log_softmax(logits.float(), dim=-1)
    if labels.is_floating_point() and labels.dim() == logits.dim():
        if weight is not None:
            logp = logp * weight[None, :]
        return _reduce(-torch.sum(labels * logp, dim=-1), reduction)
    picked = torch.gather(logp, 1, labels[:, None].long())[:, 0]
    if weight is not None:
        w = weight[labels]
        if reduction == "mean":
            return -torch.sum(picked * w) / torch.sum(w)
        return _reduce(-picked * w, reduction)
    return _reduce(-picked, reduction)
