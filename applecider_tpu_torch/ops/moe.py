"""Dense top-k mixture-of-experts dispatch (counterpart of
``applecider_tpu/ops/moe.py``): every expert runs on every sample and the
outputs combine with a top-k-masked gate matrix."""

from __future__ import annotations

import torch


def topk_mask(weights: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean (B, E) mask of the k largest entries of each row.

    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them: an
    entry's rank is the number of entries above it plus the number of equal
    entries before it. (``torch.topk`` leaves the order of ties
    unspecified, and bf16 router gates tie often.)
    """
    E = weights.shape[-1]
    idx = torch.arange(E, device=weights.device)
    above = weights[:, None, :] > weights[:, :, None]  # [b, e, e']: w[e'] > w[e]
    tie_before = (weights[:, None, :] == weights[:, :, None]) & (idx[None, :] < idx[:, None])
    rank = (above | tie_before).sum(dim=-1)
    return rank < k


def topk_dense_dispatch(expert_outputs: torch.Tensor, router_weights: torch.Tensor,
                        k: int = 2) -> torch.Tensor:
    """(B, E, C) expert outputs, (B, E) gates -> (B, C) top-k weighted sum."""
    mask = topk_mask(router_weights, k)
    gated = torch.where(mask, router_weights, 0.0).to(expert_outputs.dtype)
    return torch.einsum("be,bec->bc", gated, expert_outputs)
