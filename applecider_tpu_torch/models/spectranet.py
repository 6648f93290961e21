"""SpectraNet spectra encoder, embedding mode.

Counterpart of ``SpectraBlock`` and ``SpectraNetModule(embedding=True)`` in
``applecider_tpu/models/spectranet.py``. Activations are (B, L, C) at every
module boundary, as in the JAX package; each conv bank runs channels-first
inside the block.

Dtypes follow the JAX package's promotion exactly: a conv runs in its
input's dtype and adds its f32 bias after, which lifts a bf16 product to
f32, so the LN+GELU epilogue (kernel K3) always sees f32; the block then
casts to the compute dtype, the 1x1 downsample adds its f32 bias again, and
in bf16 mode every stage after the first convolves in f32. The adaptive max
pool returns f32 and the head runs in f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from applecider_tpu_torch.models.layers import LayerNorm, LayerNormGelu, Linear, gelu_exact, uniform_
from applecider_tpu_torch.ops.conv1d import conv1d_ncl, max_pool1d


class Conv1d(nn.Module):
    """Parameters of one 'same' odd-K conv: weight (Cout, Cin, K), f32 bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator=None) -> None:
        cout, cin, k = self.weight.shape
        bound = 1.0 / math.sqrt(cin * k)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)


class SpectraBlock(nn.Module):
    """Multi-kernel conv bank -> LN+GELU (K3) -> cast (-> 1x1 conv + max pool 4)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_sizes: Sequence[int],
                 do_pool: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.n_convs = len(kernel_sizes)
        self.do_pool = do_pool
        self.dtype = dtype
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"conv_{i}", Conv1d(in_channels, out_channels, k))
        self.norm = LayerNormGelu(out_channels * len(kernel_sizes))
        if do_pool:
            self.downsample = Conv1d(out_channels * len(kernel_sizes), out_channels, 1)
        self.out_channels = out_channels if do_pool else out_channels * len(kernel_sizes)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x (B, L, Cin) -> (B, L or L // 4, C_out)."""
        xc = x.transpose(1, 2)
        convs = [getattr(self, f"conv_{i}") for i in range(self.n_convs)]
        y = torch.cat([conv1d_ncl(xc, c.weight, c.bias) for c in convs], dim=1)
        y = self.norm(y.transpose(1, 2).contiguous(), kernels=kernels)
        if self.dtype is not None:
            y = y.to(self.dtype)
        if self.do_pool:
            w = self.downsample.weight[:, :, 0]
            y = torch.nn.functional.linear(y, w.to(y.dtype)) + self.downsample.bias
            y = max_pool1d(y, 4)
        return y


class SpectraNetModule(nn.Module):
    """Five-stage SpectraNet returning the pre-classifier hidden (B, head_hidden)."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 depths: Sequence[int] = (1, 1, 1, 1, 1),
                 kernel_sizes_per_stage: Sequence[Sequence[int]] = (
                     (3, 61, 1021), (3, 31, 251), (3, 15, 61), (3, 11, 31), (3, 7, 13)),
                 head_hidden: int = 384, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.block_names = []
        cin = 1
        n_stages = len(channels)
        for s in range(n_stages):
            for d in range(int(depths[s])):
                name = f"stage{s}_block{d}"
                block = SpectraBlock(
                    cin, int(channels[s]), tuple(kernel_sizes_per_stage[s]),
                    do_pool=(s != n_stages - 1) and d == int(depths[s]) - 1, dtype=dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                cin = block.out_channels
        self.head_fc1 = Linear(cin, head_hidden)
        self.head_norm = LayerNorm(head_hidden)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x (B, L) or (B, L, 1) spectrum -> (B, head_hidden) f32."""
        if x.dim() == 2:
            x = x[..., None]
        x = x.to(self.dtype or torch.float32)
        for name in self.block_names:
            x = getattr(self, name)(x, kernels=kernels)
        x = x.amax(dim=1).float()  # adaptive max pool over length
        return gelu_exact(self.head_norm(self.head_fc1(x)))
