"""The training criteria and class weights of the JAX package's
``applecider_tpu/ops/losses.py``: ``focal_loss``, ``cross_entropy``,
``dice_loss``, ``multiclass_bce_loss``, ``expert_specialization_loss``,
``class_balanced_weights`` and ``power_class_weights``.

The losses take logits (B, C) and integer labels (B,) unless stated
otherwise, compute in f32 and reduce with ``mean`` by default, as the torch
losses the reference trains with. The class weights are host-side NumPy.
"""

from __future__ import annotations

import numpy as np
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


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    """Soft dice of the softmax probabilities against one-hot targets, one
    minus its mean over classes."""
    probs = torch.softmax(logits.float(), dim=-1)
    y = F.one_hot(labels.long(), logits.shape[-1]).float()
    intersection = torch.sum(probs * y, dim=0)
    denom = torch.sum(probs, dim=0) + torch.sum(y, dim=0)
    return 1.0 - torch.mean((2.0 * intersection + smooth) / (denom + smooth))


def multiclass_bce_loss(logits: torch.Tensor, labels: torch.Tensor, reduction: str = "mean"
                        ) -> torch.Tensor:
    """Per-class sigmoid BCE against one-hot targets, summed over classes."""
    y = F.one_hot(labels.long(), logits.shape[-1]).float()
    x = logits.float()
    per = torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-torch.abs(x)))
    return _reduce(torch.sum(per, dim=-1), reduction)


def expert_specialization_loss(logits: torch.Tensor, labels: torch.Tensor,
                               router_weights: torch.Tensor, gamma: float = 2.0,
                               spec_weight: float = 0.25, num_experts: int | None = None
                               ) -> torch.Tensor:
    """Focal loss plus ``spec_weight`` times the MSE of the router weights
    toward the one-hot of expert ``label % E``."""
    num_experts = num_experts or router_weights.shape[-1]
    base = focal_loss(logits, labels, gamma=gamma)
    target = F.one_hot(labels.long() % num_experts, num_experts).float()
    return base + spec_weight * torch.mean((router_weights.float() - target) ** 2)


def class_balanced_weights(class_counts, beta: float = 0.9999) -> np.ndarray:
    """Effective-number class weights ``(1 - beta) / (1 - beta^n)``,
    normalised to sum to C."""
    counts = np.asarray(class_counts, dtype=np.float64)
    weights = (1.0 - beta) / np.maximum(1.0 - np.power(beta, counts), 1e-12)
    return (weights / weights.sum() * len(counts)).astype(np.float32)


def power_class_weights(class_counts, exponent: float = 1.0) -> np.ndarray:
    """``N / count^exponent`` class weights, a count below 1 taken as 1."""
    counts = np.asarray(class_counts, dtype=np.float64)
    return (counts.sum() / np.power(np.maximum(counts, 1.0), exponent)).astype(np.float32)
