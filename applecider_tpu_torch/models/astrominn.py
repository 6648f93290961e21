"""AstroMiNN image + metadata mixture of experts (counterpart of
``applecider_tpu/models/astrominn.py``): eight gated-residual metadata
towers over fixed column slices, a ConvNeXt image tower with a tanh-gated
head, a sigmoid router and a top-2 dense dispatch over the experts.

Dropout sites, live in ``train()`` mode, at the rates the flax modules
hard-code: 0.25 on each tower block's gate and main branches, 0.4 in the
image head, 0.3 on the router."""

from __future__ import annotations

import torch
from torch import nn

from applecider_tpu_torch.models.convnext import ConvNeXt
from applecider_tpu_torch.models.layers import LayerNorm, Linear, gelu_exact
from applecider_tpu_torch.ops.dropout import FastDropout
from applecider_tpu_torch.ops.moe import topk_dense_dispatch

# metadata column slices (the JAX package's TOWER_SLICES)
TOWER_SLICES = {
    "nst1_tower": [0, 2],
    "nst2_tower": [1, 3],
    "spatial_tower": [2, 3, 4],
    "psf_tower": [5, 14],
    "mag_tower": [6, 9, 10, 13, 15, 17, 18],
    "coord_tower": [7, 8],
    "mega_tower": list(range(19)),
    "lc_tower": [6, 9, 10, 13, 15, 17, 18, 19, 20, 21, 22, 23],
}


class ResidualTowerBlock(nn.Module):
    """out = main(h) * sigmoid(gate(h)) + skip(x), h = GELU(start(x)); each
    branch drops ``dropout`` after its LayerNorm."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, dropout: float = 0.25,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.start = Linear(in_dim, hidden_dim, dtype=dtype)
        self.gate_norm = LayerNorm(hidden_dim, dtype=dtype)
        self.gate_drop = FastDropout(dropout)
        self.gate_fc = Linear(hidden_dim, output_dim, dtype=dtype)
        self.main_norm = LayerNorm(hidden_dim, dtype=dtype)
        self.main_drop = FastDropout(dropout)
        self.main_fc = Linear(hidden_dim, output_dim, dtype=dtype)
        self.skip = Linear(in_dim, output_dim, dtype=dtype) if in_dim != output_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_exact(self.start(x))
        g = torch.sigmoid(self.gate_fc(self.gate_drop(self.gate_norm(h))))
        m = self.main_fc(self.main_drop(self.main_norm(h)))
        return m * g + (x if self.skip is None else self.skip(x))


class SplitHeadImageTower(nn.Module):
    """ConvNeXt features -> main MLP head, modulated by a tanh aux head."""

    def __init__(self, outdims: int, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 dtype: torch.dtype | None = None):
        super().__init__()
        f = int(dims[-1])
        self.backbone = ConvNeXt(depths, dims, dtype=dtype)
        self.main_norm = LayerNorm(f, dtype=dtype)
        self.main_fc1 = Linear(f, f // 2, dtype=dtype)
        self.main_drop = FastDropout(0.4)
        self.main_fc2 = Linear(f // 2, f, dtype=dtype)
        self.main_fc3 = Linear(f, outdims, dtype=dtype)
        self.aux_norm = LayerNorm(f, dtype=dtype)
        self.aux_fc = Linear(f, outdims, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        m = self.main_drop(torch.relu(self.main_fc1(self.main_norm(gelu_exact(feats)))))
        m = self.main_fc3(self.main_fc2(m))
        a = torch.tanh(self.aux_fc(self.aux_norm(feats)))
        return m * a


class AstroMiNNModule(nn.Module):
    def __init__(self, num_experts: int = 4, towers_hidden_dims: int = 16,
                 towers_outdims: int = 32, fusion_hidden_dims: int = 128,
                 fusion_outdims: int = 32, moe_output_dims: int = 5,
                 backbone_depths=(3, 3, 9, 3), backbone_dims=(96, 192, 384, 768),
                 router_dropout: float = 0.3, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.num_experts = num_experts
        th, to, fo = towers_hidden_dims, towers_outdims, fusion_outdims
        towers = {  # name -> (hidden, out)
            "nst1_tower": (th, fo), "nst2_tower": (th, fo), "spatial_tower": (th, to),
            "psf_tower": (th, to), "mag_tower": (2 * th, to), "coord_tower": (th, fo),
            "mega_tower": (128, to), "lc_tower": (3 * th, to),
        }
        for name, (hid, out) in towers.items():
            self.add_module(name, ResidualTowerBlock(len(TOWER_SLICES[name]), hid, out, dtype=dtype))
            # column indices live on the model's device: indexing with a
            # Python list would copy it to the card and wait for the queue
            self.register_buffer(f"{name}_cols", torch.tensor(TOWER_SLICES[name]), persistent=False)
        self.image_tower = SplitHeadImageTower(to, backbone_depths, backbone_dims, dtype=dtype)
        fusion_dims = 6 * to + 3 * fo
        self.router_fc1 = Linear(fusion_dims, fusion_dims // 2, dtype=dtype)
        self.router_drop = FastDropout(router_dropout)
        self.router_fc2 = Linear(fusion_dims // 2, num_experts, dtype=dtype)
        for i in range(num_experts):
            self.add_module(f"expert_{i}", ResidualTowerBlock(
                fusion_dims, fusion_hidden_dims, moe_output_dims, dtype=dtype))

    def forward(self, metadata: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """metadata (B, 24); image (B, H, W, 3) NHWC -> (B, moe_output_dims) f32."""
        m = metadata.to(self.dtype or torch.float32)

        def tower(name):
            return getattr(self, name)(m.index_select(1, getattr(self, f"{name}_cols")))

        img = self.image_tower(image.to(self.dtype or torch.float32))
        all_feats = torch.cat([
            tower("nst1_tower"), tower("nst2_tower"), tower("spatial_tower"),
            tower("psf_tower"), tower("mag_tower"), tower("coord_tower"),
            tower("mega_tower"), img, tower("lc_tower"),
        ], dim=-1)
        r = self.router_drop(torch.tanh(self.router_fc1(all_feats)))
        router_weights = torch.sigmoid(self.router_fc2(r)).float()
        expert_outs = torch.stack(
            [getattr(self, f"expert_{i}")(all_feats) for i in range(self.num_experts)],
            dim=1).float()
        return topk_dense_dispatch(expert_outs, router_weights, k=2)
