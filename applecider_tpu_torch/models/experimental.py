"""Experimental modules of the reference's design exploration (counterpart
of ``applecider_tpu/models/experimental.py``): the 2-D positional
encodings (sine, learned, Fourier) over NHWC feature maps, the soft
centroid of an attention map, and ``CNNTower``, per-plane CNN backbones
with the science-vs-difference centroid offset. No final model uses them;
they are kept as building blocks.

As in ``models/zoo.py``, a module that flax sizes from its input takes
``input_shape`` (the sample shape: H, W, C) and its flax fields as
keyword-only arguments; parameters carry the flax names (``pe``, ``b``,
``plane{p}_conv{d}``, ``plane{p}_pos``, ``plane{p}_attn``, ``out``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.models.convnext import Conv2dTorch
from applecider_tpu_torch.models.layers import Linear, gelu_exact


def position_embedding_sine(h: int, w: int, dim: int, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """(h, w, dim) 2-D sine/cosine encoding: [sin y, cos y, sin x, cos x]
    over ``dim / 4`` geometric frequencies each."""
    if dim % 4:
        raise ValueError(f"dim must be divisible by 4, got {dim}")
    quarter = dim // 4
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None, None]
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :, None]
    freq = temperature ** (torch.arange(quarter, dtype=torch.float32, device=device) / quarter)
    y_enc = torch.cat([torch.sin(y / freq), torch.cos(y / freq)], dim=-1).expand(h, w, 2 * quarter)
    x_enc = torch.cat([torch.sin(x / freq), torch.cos(x / freq)], dim=-1).expand(h, w, 2 * quarter)
    return torch.cat([y_enc, x_enc], dim=-1)


class PositionEmbedding(nn.Module):
    """Adds a sine, learned (``pe``, (H, W, dim), N(0, 0.02)) or Fourier
    (``b``, (2, dim / 2), N(0, 1): sin and cos of 2 pi [y, x] @ b on a unit
    grid) encoding to (B, H, W, dim) maps."""

    def __init__(self, input_shape: Sequence[int], *, dim: int, kind: str = "sine"):
        super().__init__()
        if kind not in ("sine", "learned", "fourier"):
            raise ValueError(kind)
        self.dim, self.kind = dim, kind
        h, w = input_shape[0], input_shape[1]
        if kind == "learned":
            self.pe = nn.Parameter(torch.empty(h, w, dim))
        elif kind == "fourier":
            self.b = nn.Parameter(torch.empty(2, dim // 2))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            if self.kind == "learned":
                self.pe.normal_(0.0, 0.02, generator=generator)
            elif self.kind == "fourier":
                self.b.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = x.shape
        if self.kind == "sine":
            pe = position_embedding_sine(H, W, self.dim, device=x.device)
        elif self.kind == "learned":
            pe = self.pe
        else:
            yy, xx = torch.meshgrid(torch.linspace(0, 1, H, device=x.device),
                                    torch.linspace(0, 1, W, device=x.device), indexing="ij")
            proj = 2 * math.pi * torch.stack([yy, xx], dim=-1) @ self.b
            pe = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
        return x + pe[None].to(x.dtype)


def soft_centroid(attn_map: torch.Tensor) -> torch.Tensor:
    """(B, H, W) attention map -> (B, 2) soft centroid (y, x) in pixels."""
    B, H, W = attn_map.shape
    probs = torch.softmax(attn_map.reshape(B, -1), dim=-1).reshape(B, H, W)
    ys = torch.arange(H, dtype=torch.float32, device=attn_map.device)
    xs = torch.arange(W, dtype=torch.float32, device=attn_map.device)
    cy = (probs * ys[None, :, None]).sum((1, 2))
    cx = (probs * xs[None, None, :]).sum((1, 2))
    return torch.stack([cy, cx], dim=-1)


class CNNTower(nn.Module):
    """Per-plane CNN backbones over (B, H, W, P) stacked planes (sci, tmpl,
    diff): ``depth`` 3x3 convs with exact GELU, max pool 2 between them, a
    positional encoding, a 1x1 attention head whose soft centroid gives
    the diff-vs-sci offset; the pooled features and the offset go through
    ``out`` to (B, outdims) f32."""

    def __init__(self, input_shape: Sequence[int], *, channels: int = 32, depth: int = 3,
                 outdims: int = 32, pos_kind: str = "sine", dtype: torch.dtype | None = None):
        super().__init__()
        h, w, self.planes = input_shape
        self.depth = depth
        for d in range(depth - 1):
            h, w = h // 2, w // 2
        for p in range(self.planes):
            for d in range(depth):
                self.add_module(f"plane{p}_conv{d}", Conv2dTorch(1 if d == 0 else channels,
                                                                 channels, 3, padding=1,
                                                                 dtype=dtype))
            self.add_module(f"plane{p}_pos", PositionEmbedding((h, w), dim=channels,
                                                               kind=pos_kind))
            self.add_module(f"plane{p}_attn", Conv2dTorch(channels, 1, 1, dtype=dtype))
        self.out = Linear(self.planes * channels + 2, outdims, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats, centroids = [], []
        for p in range(self.planes):
            h = x[..., p: p + 1]
            for d in range(self.depth):
                h = gelu_exact(getattr(self, f"plane{p}_conv{d}")(h))
                if d < self.depth - 1:
                    h = F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
            h = getattr(self, f"plane{p}_pos")(h)
            attn = getattr(self, f"plane{p}_attn")(h)[..., 0]
            centroids.append(soft_centroid(attn.float()))
            feats.append(h.mean((1, 2)))
        offset = centroids[-1] - centroids[0]  # diff vs sci displacement
        fused = torch.cat(feats + [offset.to(feats[0].dtype)], dim=-1)
        return self.out(fused).float()
