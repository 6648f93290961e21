"""BaselineCLS photometry transformer, fusion (embedding) mode.

Counterpart of ``applecider_tpu/models/baseline_cls.py``: Linear(7 -> d) +
Time2Vec of the dt channel, a zero-init CLS token prepended (never
padded), the post-LN encoder, LayerNorm of the CLS token, returned in f32.
``dropout`` (0.40 at the published widths) is threaded through every
encoder layer; the time embedding takes none, as in the classifier.
"""

from __future__ import annotations

import torch
from torch import nn

from applecider_tpu_torch.models.layers import LayerNorm, Linear, TransformerEncoder
from applecider_tpu_torch.models.time2vec import Time2Vec

N_EVENT_FEATURES = 7


class BaselineCLSEncoder(nn.Module):
    """Projection + Time2Vec + CLS + transformer; returns all L+1 tokens."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.d_model = d_model
        self.in_proj = Linear(N_EVENT_FEATURES, d_model, dtype=dtype)
        self.time2vec = Time2Vec(d_model, dtype=dtype)
        self.cls_tok = nn.Parameter(torch.empty(1, 1, d_model))
        self.encoder = TransformerEncoder(n_layers, d_model, n_heads, 4 * d_model, dropout,
                                          dtype=dtype)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.cls_tok.zero_()

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, kernels: bool = True):
        B = x.shape[0]
        h = self.in_proj(x) + self.time2vec(x[..., 0])
        tok = self.cls_tok.to(h.dtype).expand(B, 1, self.d_model)
        h = torch.cat([tok, h], dim=1)
        pad = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=x.device),
                         pad_mask.bool()], dim=1)
        return self.encoder(h, pad, kernels=kernels)


class BaselineCLSModule(nn.Module):
    """``classification=False`` of the JAX module: the normalised CLS
    embedding, (B, d_model) f32."""

    def __init__(self, d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.40, dtype: torch.dtype | None = None):
        super().__init__()
        self.trunk = BaselineCLSEncoder(d_model, n_heads, n_layers, dropout, dtype=dtype)
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, x, pad_mask, kernels: bool = True):
        z = self.trunk(x, pad_mask, kernels=kernels)
        return self.norm(z[:, 0]).float()
