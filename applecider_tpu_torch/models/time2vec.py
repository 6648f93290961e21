"""Time2Vec embedding (counterpart of ``applecider_tpu/models/time2vec.py``):
scalar t -> [w0 t + b0, sin(w t + b)], computed in f32."""

from __future__ import annotations

import torch
from torch import nn


class Time2Vec(nn.Module):
    def __init__(self, d_model: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.w0 = nn.Parameter(torch.empty(1))
        self.b0 = nn.Parameter(torch.empty(1))
        self.w = nn.Parameter(torch.empty(d_model - 1))
        self.b = nn.Parameter(torch.empty(d_model - 1))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.w0.normal_(generator=generator)
            self.w.normal_(generator=generator)
            self.b0.zero_()
            self.b.zero_()

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """t (B, L) -> (B, L, d_model)."""
        t = t.float()[..., None]
        out = torch.cat([self.w0 * t + self.b0, torch.sin(t * self.w + self.b)], dim=-1)
        return out.to(self.dtype or out.dtype)
