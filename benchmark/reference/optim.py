"""Plain training-step arithmetic: the global-norm clip and Adam with
decoupled weight decay (AdamW; Adam where the decay is 0), from their
published definitions (Kingma and Ba 2015; Loshchilov and Hutter 2019)."""

from __future__ import annotations

import torch


def clip_by_global_norm(grads: dict, max_norm: float | None) -> dict:
    """Gradients scaled by max_norm / norm where their global norm is at
    least max_norm; unchanged below it or with no clip."""
    if not max_norm:
        return grads
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    if norm < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


class AdamW:
    """p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), with m and v the
    exponential means of the gradient and its square, bias-corrected."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.m: dict = {}
        self.v: dict = {}
        self.t = 0

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        for k, p in params.items():
            g = grads[k]
            m = self.m[k] = self.b1 * self.m.get(k, torch.zeros_like(g)) + (1 - self.b1) * g
            v = self.v[k] = self.b2 * self.v.get(k, torch.zeros_like(g)) + (1 - self.b2) * g * g
            m_hat = m / (1 - self.b1 ** self.t)
            v_hat = v / (1 - self.b2 ** self.t)
            with torch.no_grad():
                p -= self.lr * (m_hat / (torch.sqrt(v_hat) + self.eps) + self.wd * p)
