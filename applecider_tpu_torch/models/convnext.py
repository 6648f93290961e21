"""ConvNeXt backbone (counterpart of ``applecider_tpu/models/convnext.py``).

Images are NHWC at every module boundary, as in the JAX package. A conv
views its NHWC input as a channels-last NCHW tensor (``permute``, no copy)
for ``F.conv2d`` and views the result back. The depthwise 7x7 conv is a
grouped conv; the JAX package's ``_dw_impl``/``_dw_gather_onehot`` are TPU
lowering choices and are not ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.models.layers import LayerNorm, Linear, gelu_exact, uniform_
from applecider_tpu_torch.ops.quant import quant_conv


class LayerNorm6(LayerNorm):
    """LayerNorm with the ConvNeXt eps 1e-6."""

    def __init__(self, features: int, dtype: torch.dtype | None = None):
        super().__init__(features, eps=1e-6, dtype=dtype)


class Conv2dTorch(nn.Module):
    """Conv2d on NHWC input: weight (Cout, Cin/groups, k, k), f32 bias added
    after the product, result cast to ``dtype`` (f32 when None)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 groups: int = 1, padding: int = 0, dtype: torch.dtype | None = None):
        super().__init__()
        self.stride, self.groups, self.padding = stride, groups, padding
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator=None) -> None:
        _, cin_g, kh, kw = self.weight.shape
        bound = 1.0 / math.sqrt(cin_g * kh * kw)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the opt-in int8 serving path (ops.quant), before any float route
        q = quant_conv(x, self, self.dtype or x.dtype, self.stride, self.padding, self.groups)
        if q is not None:
            return q
        dt = self.dtype or torch.float32
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), stride=self.stride,
                     padding=self.padding, groups=self.groups)
        return (y.permute(0, 2, 3, 1) + self.bias).to(dt)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init: float = 1e-6, dtype: torch.dtype | None = None):
        super().__init__()
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2dTorch(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm6(dim, dtype=dtype)
        self.pwconv1 = Linear(dim, 4 * dim, dtype=dtype)
        self.pwconv2 = Linear(4 * dim, dim, dtype=dtype)
        self.gamma = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.pwconv2(gelu_exact(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + h * self.gamma.to(h.dtype)


class ConvNeXt(nn.Module):
    """Feature extractor: NHWC image -> (B, dims[-1]) pooled, normalised."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768), in_chans: int = 3,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.depths = tuple(int(d) for d in depths)
        self.stem_conv = Conv2dTorch(in_chans, dims[0], 4, stride=4, dtype=dtype)
        self.stem_norm = LayerNorm6(dims[0], dtype=dtype)
        for s in range(len(self.depths)):
            if s > 0:
                self.add_module(f"downsample{s}_norm", LayerNorm6(dims[s - 1], dtype=dtype))
                self.add_module(f"downsample{s}_conv",
                                Conv2dTorch(dims[s - 1], dims[s], 2, stride=2, dtype=dtype))
            for b in range(self.depths[s]):
                self.add_module(f"stage{s}_block{b}", ConvNeXtBlock(dims[s], dtype=dtype))
        self.head_norm = LayerNorm6(dims[-1], dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem_norm(self.stem_conv(x))
        for s in range(len(self.depths)):
            if s > 0:
                x = getattr(self, f"downsample{s}_conv")(getattr(self, f"downsample{s}_norm")(x))
            for b in range(self.depths[s]):
                x = getattr(self, f"stage{s}_block{b}")(x)
        return self.head_norm(x.mean(dim=(1, 2)))


def convnext_tiny(dtype: torch.dtype | None = None) -> ConvNeXt:
    """ConvNeXt-tiny: depths (3, 3, 9, 3), widths (96, 192, 384, 768)."""
    return ConvNeXt(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768), dtype=dtype)
