"""The paper's comparison baselines (counterpart of
``applecider_tpu/models/zoo.py``).

Seven models, each registered as a task under its short name and the JAX
package's dotted name (``applecider_tpu.models.zoo.<Name>Task``):

* ``BTSModel``: the BTSbot CNN over NHWC cutouts (four 5x5 convs, max pool
  2 then 4, an NHWC flatten into ``fc``);
* ``GalSpecNet``: a VALID conv1d chain over spectra, always in the input's
  f32, its flatten in (L, C) order;
* ``MetaModel``: the AstroM3 metadata MLP;
* ``Informer``: ProbSparse attention over event sequences (the top u =
  factor * ceil(ln L) queries by a strided key sample attend, the rest take
  mean(V)); ``head`` "mean" or "flatten", optional distilling conv + pool;
* ``SpectraViT``: a post-LN ViT (the port's ``TransformerEncoder``, so its
  attention is kernel K4 under autograd and K2 without) and an MLP head;
* ``SpectraEfficientNetV2``: fused and plain MBConv stages, BatchNorm on
  the batch's statistics in ``train()`` and the running buffers in
  ``eval()``, never updating them (the JAX task drops the updated
  ``batch_stats``);
* ``SpectraConvNeXt``: the port's ConvNeXt (ConvNeXt-base widths) and ``fc``.

Each module sizes itself from the input's shape (``input_shape``, the
batch's sample shape), as flax sizes its layers from the first batch; the
keyword-only arguments are the flax module's fields, which the config's
``[model.<Name>]`` section sets. Submodules and parameters carry the flax
names (``Conv2dTorch_0``, ``Linear_0``, ``ViT_0``, ``ConvNeXt_0``, ...), so
``utils.weights.from_jax_params`` loads a JAX model strictly. The raw 3-D
parameters ``token_kernel`` and ``conv{i}_kernel`` keep their flax layout
(K, Cin, Cout); the bridge passes them through as they are.

Layers follow the JAX package's dtypes one by one: every ``fc``, Informer's
token conv, feed-forward and LayerNorms, and SpectraViT's two head Linears
are built without ``dtype`` there, so they compute in f32 in bf16 mode
here too.

``ZooTask`` is the task of each: cross entropy, ``adam(lr)``, inputs pulled
from the batch by key. It holds no module until ``init(batch)`` sizes one
from the first host batch, which ``AppleCiderRuntime`` calls where the JAX
runtime calls ``task.init`` (before the ``Trainer`` exists).
"""

from __future__ import annotations

import inspect
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task, adam, maybe_softmax
from applecider_tpu_torch.models.convnext import ConvNeXt, Conv2dTorch
from applecider_tpu_torch.models.layers import LayerNorm, Linear, TransformerEncoder, init_weights
from applecider_tpu_torch.ops.conv1d import conv1d_direct, max_pool1d
from applecider_tpu_torch.ops.dropout import FastDropout
from applecider_tpu_torch.ops.losses import cross_entropy
from applecider_tpu_torch.parallel.mesh import Mesh, data_sum
from applecider_tpu_torch.registry import register_model


def _max_pool2d(x: torch.Tensor, window: int) -> torch.Tensor:
    """flax ``nn.max_pool`` (window = stride, VALID) over NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def _normal_(t: torch.Tensor, std: float, generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


class BTSModel(nn.Module):
    """BTSbot-style CNN over (B, H, W, C) cutout stacks."""

    def __init__(self, input_shape: Sequence[int], *, conv1_channels: int = 32,
                 conv2_channels: int = 64, conv_kernel: int = 5, dropout1: float = 0.25,
                 dropout2: float = 0.25, num_classes: int = 5, classification: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        h, w, cin = input_shape
        pad = conv_kernel // 2
        chans = (cin, conv1_channels, conv1_channels, conv2_channels, conv2_channels)
        for i in range(4):
            self.add_module(f"Conv2dTorch_{i}", Conv2dTorch(chans[i], chans[i + 1], conv_kernel,
                                                            padding=pad, dtype=dtype))
        grow = 2 * pad - conv_kernel + 1  # each conv's change of size
        h, w = (h + 2 * grow) // 2, (w + 2 * grow) // 2
        h, w = (h + 2 * grow) // 4, (w + 2 * grow) // 4
        if h * w == 0:
            raise ValueError(f"BTSModel takes NHWC images; {tuple(input_shape)} pools to nothing")
        self.drop1, self.drop2 = FastDropout(dropout1), FastDropout(dropout2)
        self.fc = Linear(h * w * conv2_channels, num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        for i in range(2):
            x = torch.relu(getattr(self, f"Conv2dTorch_{i}")(x))
        x = self.drop1(_max_pool2d(x, 2))
        for i in range(2, 4):
            x = torch.relu(getattr(self, f"Conv2dTorch_{i}")(x))
        x = self.drop2(_max_pool2d(x, 4))
        x = x.reshape(x.shape[0], -1)  # NHWC order, as flax flattens
        if self.fc is not None:
            x = self.fc(x)
        return x.float()


class GalSpecNet(nn.Module):
    """Conv-ReLU[-MaxPool] VALID 1-D chain over (B, L) or (B, L, C) spectra,
    in the input's dtype (f32 from ``to_tensor``) whatever ``dtype`` says;
    ``dtype`` is taken as the flax module's field, which no layer reads."""

    def __init__(self, input_shape: Sequence[int], *,
                 conv_channels: Sequence[int] = (1, 64, 64, 32, 32), kernel_size: int = 5,
                 mp_kernel_size: int = 2, dropout: float = 0.3, num_classes: int = 9,
                 classification: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        length = input_shape[0]
        cin = input_shape[1] if len(input_shape) == 2 else 1
        self.n_convs = len(conv_channels) - 1
        self.mp_kernel_size = mp_kernel_size
        for i in range(self.n_convs):
            cout = int(conv_channels[i + 1])
            self.register_parameter(f"conv{i}_kernel",
                                    nn.Parameter(torch.empty(kernel_size, cin, cout)))
            self.register_parameter(f"conv{i}_bias", nn.Parameter(torch.empty(cout)))
            length -= kernel_size - 1
            if i < self.n_convs - 1:
                length //= mp_kernel_size
            cin = cout
        self.drop = FastDropout(dropout)
        self.fc = Linear(length * cin, num_classes) if classification else None

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            for i in range(self.n_convs):
                kernel = getattr(self, f"conv{i}_kernel")
                bound = 1.0 / math.sqrt(kernel.shape[0] * kernel.shape[1])
                kernel.uniform_(-bound, bound, generator=generator)
                getattr(self, f"conv{i}_bias").zero_()

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        if x.dim() == 2:
            x = x[..., None]
        for i in range(self.n_convs):
            kernel = getattr(self, f"conv{i}_kernel")
            y = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0).to(x.dtype))
            x = torch.relu(y.transpose(1, 2) + getattr(self, f"conv{i}_bias"))
            if i < self.n_convs - 1:
                x = max_pool1d(x, self.mp_kernel_size)
        x = self.drop(x.reshape(x.shape[0], -1))  # (L, C) order
        if self.fc is not None:
            x = self.fc(x)
        return x.float()


class MetaModel(nn.Module):
    """AstroM3-style metadata MLP: 2 x (Linear, ReLU, dropout), ``fc``."""

    def __init__(self, input_shape: Sequence[int], *, hidden_dim: int = 128,
                 dropout: float = 0.2, num_classes: int = 5, classification: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.Linear_0 = Linear(input_shape[-1], hidden_dim, dtype=dtype)
        self.Linear_1 = Linear(hidden_dim, hidden_dim, dtype=dtype)
        self.drop0, self.drop1 = FastDropout(dropout), FastDropout(dropout)
        self.fc = Linear(hidden_dim, num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        x = self.drop0(torch.relu(self.Linear_0(x)))
        x = self.drop1(torch.relu(self.Linear_1(x)))
        if self.fc is not None:
            x = self.fc(x)
        return x.float()


class ProbSparseSelfAttention(nn.Module):
    """Informer ProbSparse attention with static shapes: the top u = factor
    * ceil(ln L) queries by the sparsity measure max - mean over a strided
    key sample attend to every key; every other row takes mean(V). Plain
    PyTorch, as the JAX package leaves it to XLA (``top_k``, gathers and a
    scatter), with no Pallas kernel."""

    def __init__(self, d_model: int, num_heads: int, factor: int = 5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads, self.factor = num_heads, factor
        self.in_proj = Linear(d_model, 3 * d_model, dtype=dtype)
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        hd = D // H
        q, k, v = (t.reshape(B, L, H, hd).transpose(1, 2) for t in self.in_proj(x).split(D, -1))
        u = max(min(int(self.factor * math.ceil(math.log(max(L, 2)))), L), 1)
        stride = max(L // u, 1)
        k_sample = k[:, :, ::stride][:, :, :u]
        qk_sample = torch.matmul(q, k_sample.transpose(-1, -2)) / math.sqrt(hd)
        sparsity = qk_sample.amax(-1) - qk_sample.mean(-1)  # (B, H, L)
        top = sparsity.topk(u, dim=-1).indices[..., None].expand(-1, -1, -1, hd)
        q_top = torch.gather(q, 2, top)
        attn = torch.softmax(torch.matmul(q_top, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = v.mean(2, keepdim=True).expand_as(v).scatter(2, top, torch.matmul(attn, v))
        return self.out_proj(ctx.transpose(1, 2).reshape(B, L, D))


class DistilConvLayer(nn.Module):
    """Informer's distilling between encoder stages: conv1d (k = 3, 'same',
    no bias) in f32, LayerNorm, ELU, MaxPool1d(3, stride 2, padding 1),
    which takes L to (L - 1) // 2 + 1; the result in ``dtype`` (f32 when
    None)."""

    def __init__(self, in_channels: int, d_model: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_model, in_channels, 3))
        self.norm = LayerNorm(d_model)

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.weight, math.sqrt(2.0 / (3 * self.weight.shape[1])), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(self.norm(conv1d_direct(x.float(), self.weight)))
        x = F.max_pool1d(x.transpose(1, 2), 3, stride=2, padding=1).transpose(1, 2)
        return x.to(self.dtype or torch.float32)


def _pool_mask(mask: torch.Tensor) -> torch.Tensor:
    """The valid mask pooled as ``DistilConvLayer`` pools the tokens."""
    m = F.max_pool1d(mask.float()[:, None, :], 3, stride=2, padding=1)[:, 0]
    return m > 0


class Informer(nn.Module):
    """Informer-style encoder classifier over (B, L, c_in) event sequences;
    ``mask`` (B, L) bool, True = valid token. ``head="flatten"`` zeroes the
    padded embeddings and flattens (B, L * d_model); ``"mean"`` averages
    the valid ones. ``distil`` halves L between stages, pooling the mask
    alongside."""

    def __init__(self, input_shape: Sequence[int], *, c_in: int = 7, d_model: int = 128,
                 n_heads: int = 8, n_layers: int = 2, dropout: float = 0.1, num_classes: int = 5,
                 classification: bool = True, head: str = "mean", distil: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        length, width = input_shape
        if width != c_in:
            raise ValueError(f"Informer takes (L, c_in = {c_in}) events, got width {width}")
        if head not in ("mean", "flatten"):
            raise ValueError(f"Informer head must be 'mean' or 'flatten', got {head!r}")
        self.d_model, self.n_layers, self.head, self.distil = d_model, n_layers, head, distil
        self.token_kernel = nn.Parameter(torch.empty(3, c_in, d_model))  # flax layout
        self.drop = FastDropout(dropout)
        for i in range(n_layers):
            self.add_module(f"attn_{i}", ProbSparseSelfAttention(d_model, n_heads, dtype=dtype))
            self.add_module(f"attn_drop_{i}", FastDropout(dropout))
            self.add_module(f"norm1_{i}", LayerNorm(d_model))
            self.add_module(f"ff1_{i}", Linear(d_model, 4 * d_model))
            self.add_module(f"ff2_{i}", Linear(4 * d_model, d_model))
            self.add_module(f"ff_drop_{i}", FastDropout(dropout))
            self.add_module(f"norm2_{i}", LayerNorm(d_model))
            if distil and i < n_layers - 1:
                self.add_module(f"distil_{i}", DistilConvLayer(d_model, d_model, dtype=dtype))
                length = (length - 1) // 2 + 1
        self.norm_final = LayerNorm(d_model)
        self.final_drop = FastDropout(dropout)
        features = length * d_model if head == "flatten" else d_model
        self.fc = Linear(features, num_classes) if classification else None

    def reset_parameters(self, generator=None) -> None:
        _normal_(self.token_kernel, math.sqrt(2.0 / (3 * self.token_kernel.shape[1])), generator)

    def positions(self, length: int, device) -> torch.Tensor:
        """(L, d_model) sinusoidal table: sin on even, cos on odd features."""
        pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, self.d_model, 2, device=device, dtype=torch.float32)
                        * (-math.log(10000.0) / self.d_model))
        pe = torch.zeros(length, self.d_model, device=device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return pe

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                kernels: bool = True) -> torch.Tensor:
        B, L, _ = x.shape
        h = conv1d_direct(x.float(), self.token_kernel.permute(2, 1, 0))
        h = self.drop(h + self.positions(L, x.device)[None])
        for i in range(self.n_layers):
            a = getattr(self, f"attn_{i}")(h)
            h = getattr(self, f"norm1_{i}")(h + getattr(self, f"attn_drop_{i}")(a))
            f = getattr(self, f"ff2_{i}")(torch.relu(getattr(self, f"ff1_{i}")(h)))
            h = getattr(self, f"norm2_{i}")(h + getattr(self, f"ff_drop_{i}")(f))
            if self.distil and i < self.n_layers - 1:
                h = getattr(self, f"distil_{i}")(h)
                if mask is not None:
                    mask = _pool_mask(mask)
        h = self.final_drop(self.norm_final(h))
        if self.head == "flatten":
            valid = torch.ones(h.shape[:2], dtype=h.dtype, device=h.device) if mask is None \
                else mask.to(h.dtype)
            h = (h * valid[..., None]).reshape(B, -1)
        elif mask is not None:
            valid = mask.to(h.dtype)[..., None]
            h = (h * valid).sum(1) / torch.clamp(valid.sum(1), min=1.0)
        else:
            h = h.mean(1)
        if self.fc is not None:
            h = self.fc(h)
        return h.float()


class ViT(nn.Module):
    """Patch embedding, CLS token, learned positions and the port's post-LN
    ``TransformerEncoder`` (dropout 0: K4 at rate 0 under autograd, K2
    without), then LayerNorm of the CLS row."""

    def __init__(self, input_shape: Sequence[int], patch: int = 16, dim: int = 256,
                 depth: int = 4, heads: int = 8, dtype: torch.dtype | None = None):
        super().__init__()
        h, w, cin = input_shape
        if h < patch or w < patch:
            raise ValueError(f"ViT takes NHWC images of at least {patch} x {patch} pixels, got "
                             f"{tuple(input_shape)}")
        self.dim = dim
        self.patch = Conv2dTorch(cin, dim, patch, stride=patch, dtype=dtype)
        self.cls = nn.Parameter(torch.empty(1, 1, dim))
        self.pos = nn.Parameter(torch.empty(1, (h // patch) * (w // patch) + 1, dim))
        self.encoder = TransformerEncoder(depth, dim, heads, dim * 4, 0.0, dtype=dtype)
        self.norm = LayerNorm(dim)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.cls.zero_()
        _normal_(self.pos, 0.02, generator)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        B = x.shape[0]
        x = self.patch(x).reshape(B, -1, self.dim)
        # the f32 CLS token promotes the bf16 patches to f32, as jnp.concatenate does
        x = torch.cat([self.cls.expand(B, 1, self.dim), x.float()], dim=1) + self.pos
        x = self.encoder(x, None, kernels=kernels)
        return self.norm(x[:, 0])


class SpectraViT(nn.Module):
    """ViT backbone and an MLP head (f32 Linears) over 2-D spectra renders."""

    def __init__(self, input_shape: Sequence[int], *, s_dim: int = 512, dropout: float = 0.3,
                 num_classes: int = 9, classification: bool = True, backbone_dim: int = 256,
                 backbone_depth: int = 4, dtype: torch.dtype | None = None):
        super().__init__()
        self.ViT_0 = ViT(input_shape, dim=backbone_dim, depth=backbone_depth, dtype=dtype)
        self.Linear_0 = Linear(backbone_dim, s_dim)
        self.Linear_1 = Linear(s_dim, 256)
        self.drop0, self.drop1 = FastDropout(dropout), FastDropout(dropout)
        self.fc = Linear(256, num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        h = self.drop0(torch.relu(self.Linear_0(self.ViT_0(x, kernels=kernels))))
        h = self.drop1(torch.relu(self.Linear_1(h)))
        if self.fc is not None:
            h = self.fc(h)
        return h.float()


# ------------------------------------------------------- EfficientNetV2
class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=not training, momentum 0.9)``
    over the last axis, as the JAX task runs it: in ``train()`` the batch's
    statistics (f32, the variance as E[x^2] - E[x]^2 clipped at 0), in
    ``eval()`` the ``running_mean``/``running_var`` buffers, which no mode
    updates (the JAX task drops the updated ``batch_stats``). Output in
    ``dtype`` (f32 when None). Over a data-parallel ``mesh`` (set by the
    Trainer) the statistics are the global batch's: the sums of x and x^2
    and the count are all-reduced over the data axis."""

    def __init__(self, features: int, eps: float, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.mesh: Mesh | None = None
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training and self.mesh is not None:
            axes = tuple(range(x.dim() - 1))
            count = torch.full((1,), xf[..., 0].numel(), dtype=torch.float32, device=x.device)
            sums = data_sum(torch.cat([xf.sum(axes), torch.square(xf).sum(axes), count]),
                            self.mesh)
            C = x.shape[-1]
            mean = sums[:C] / sums[-1]
            var = torch.clamp(sums[C:2 * C] / sums[-1] - torch.square(mean), min=0.0)
        elif self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp(torch.square(xf).mean(axes) - torch.square(mean), min=0.0)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype or torch.float32)


class SqueezeExcite(nn.Module):
    """SE gate: global pool -> 1x1 reduce (SiLU) -> 1x1 expand (sigmoid)."""

    def __init__(self, channels: int, reduced: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.reduce = Conv2dTorch(channels, reduced, 1, dtype=dtype)
        self.expand = Conv2dTorch(reduced, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = F.silu(self.reduce(x.mean((1, 2), keepdim=True)))
        return x * torch.sigmoid(self.expand(s))


class MBConvBlock(nn.Module):
    """EfficientNetV2 block: fused-MBConv (expand conv k x k, or one k x k
    conv when ``expand`` is 1) or MBConv (1x1 expand, depthwise k x k, SE,
    1x1 project); identity residual at stride 1 and equal widths."""

    def __init__(self, cin: int, out_ch: int, expand: int, kernel: int, stride: int,
                 se_ratio: float, fused: bool, dtype: torch.dtype | None = None):
        super().__init__()
        mid = cin * expand
        self.fused, self.expand = fused, expand
        self.residual = stride == 1 and cin == out_ch
        pad = kernel // 2

        def bn(name, c):
            self.add_module(name, BatchNorm(c, 1e-3, dtype=dtype))

        if fused:
            if expand != 1:
                self.expand_conv = Conv2dTorch(cin, mid, kernel, stride=stride, padding=pad,
                                               dtype=dtype)
                bn("bn0", mid)
                self.project_conv = Conv2dTorch(mid, out_ch, 1, dtype=dtype)
            else:
                self.project_conv = Conv2dTorch(cin, out_ch, kernel, stride=stride, padding=pad,
                                                dtype=dtype)
            bn("bn1", out_ch)
        else:
            if expand != 1:
                self.expand_conv = Conv2dTorch(cin, mid, 1, dtype=dtype)
                bn("bn0", mid)
            self.dw_conv = Conv2dTorch(mid, mid, kernel, stride=stride, padding=pad, groups=mid,
                                       dtype=dtype)
            bn("bn1", mid)
            self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)), dtype=dtype) \
                if se_ratio > 0 else None
            self.project_conv = Conv2dTorch(mid, out_ch, 1, dtype=dtype)
            bn("bn2", out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        if self.fused:
            if self.expand != 1:
                h = self.bn1(self.project_conv(F.silu(self.bn0(self.expand_conv(h)))))
            else:
                h = F.silu(self.bn1(self.project_conv(h)))
        else:
            if self.expand != 1:
                h = F.silu(self.bn0(self.expand_conv(h)))
            h = F.silu(self.bn1(self.dw_conv(h)))
            if self.se is not None:
                h = self.se(h)
            h = self.bn2(self.project_conv(h))
        return h + x if self.residual else h


# stage specs: (fused, expand, kernel, stride, channels, blocks, se_ratio)
EFFNETV2_ARCHS: dict = {
    "l": (32, (
        (True, 1, 3, 1, 32, 4, 0.0), (True, 4, 3, 2, 64, 7, 0.0),
        (True, 4, 3, 2, 96, 7, 0.0), (False, 4, 3, 2, 192, 10, 0.25),
        (False, 6, 3, 1, 224, 19, 0.25), (False, 6, 3, 2, 384, 25, 0.25),
        (False, 6, 3, 1, 640, 7, 0.25),
    )),
    # what the reference loads: its class is named ...V2L, its timm tag is
    # tf_efficientnetv2_m
    "m": (24, (
        (True, 1, 3, 1, 24, 3, 0.0), (True, 4, 3, 2, 48, 5, 0.0),
        (True, 4, 3, 2, 80, 5, 0.0), (False, 4, 3, 2, 160, 7, 0.25),
        (False, 6, 3, 1, 176, 14, 0.25), (False, 6, 3, 2, 304, 18, 0.25),
        (False, 6, 3, 1, 512, 5, 0.25),
    )),
    # a CPU-sized miniature with one stage of each block kind
    "tiny": (8, (
        (True, 1, 3, 1, 8, 1, 0.0), (True, 2, 3, 2, 16, 1, 0.0),
        (False, 2, 3, 2, 16, 2, 0.25),
    )),
}


class EfficientNetV2(nn.Module):
    """Stem -> staged blocks ``stage{s}_block{b}`` -> 1x1 head; returns the
    pooled (B, head_features) f32 embedding."""

    def __init__(self, in_channels: int, arch: str = "m", head_features: int = 1280,
                 dtype: torch.dtype | None = None):
        super().__init__()
        stem_ch, stages = EFFNETV2_ARCHS[arch]
        self.stem_conv = Conv2dTorch(in_channels, stem_ch, 3, stride=2, padding=1, dtype=dtype)
        self.stem_bn = BatchNorm(stem_ch, 1e-3, dtype=dtype)
        self.block_names = []
        cin = stem_ch
        for si, (fused, expand, k, stride, ch, blocks, se) in enumerate(stages):
            for bi in range(blocks):
                name = f"stage{si}_block{bi}"
                self.add_module(name, MBConvBlock(cin, ch, expand, k, stride if bi == 0 else 1,
                                                  se, fused, dtype=dtype))
                self.block_names.append(name)
                cin = ch
        self.head_conv = Conv2dTorch(cin, head_features, 1, dtype=dtype)
        self.head_bn = BatchNorm(head_features, 1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        return x.mean((1, 2)).float()


class SpectraEfficientNetV2(nn.Module):
    """EfficientNetV2 backbone, then Linear -> BatchNorm1d -> ReLU ->
    dropout -> Linear(256) -> BatchNorm1d -> ReLU -> dropout (-> ``fc``);
    BatchNorm eps 1e-3 in the backbone, 1e-5 in the head."""

    def __init__(self, input_shape: Sequence[int], *, arch: str = "m", s_dim: int = 512,
                 dropout: float = 0.3, num_classes: int = 9, classification: bool = True,
                 head_features: int = 1280, dtype: torch.dtype | None = None):
        super().__init__()
        self.backbone = EfficientNetV2(input_shape[-1], arch, head_features, dtype=dtype)
        self.Linear_0 = Linear(head_features, s_dim, dtype=dtype)
        self.head_bn0 = BatchNorm(s_dim, 1e-5, dtype=dtype)
        self.Linear_1 = Linear(s_dim, 256, dtype=dtype)
        self.head_bn1 = BatchNorm(256, 1e-5, dtype=dtype)
        self.drop0, self.drop1 = FastDropout(dropout), FastDropout(dropout)
        self.fc = Linear(256, num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        h = self.drop0(torch.relu(self.head_bn0(self.Linear_0(self.backbone(x)))))
        h = self.drop1(torch.relu(self.head_bn1(self.Linear_1(h))))
        if self.fc is not None:
            h = self.fc(h)
        return h.float()


class SpectraConvNeXt(nn.Module):
    """The port's ConvNeXt (ConvNeXt-base widths by default) and ``fc``."""

    def __init__(self, input_shape: Sequence[int], *, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024), num_classes: int = 9,
                 classification: bool = True, dtype: torch.dtype | None = None):
        super().__init__()
        self.ConvNeXt_0 = ConvNeXt(tuple(depths), tuple(dims), in_chans=input_shape[-1],
                                   dtype=dtype)
        self.fc = Linear(dims[-1], num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        feats = self.ConvNeXt_0(x)
        if self.fc is not None:
            feats = self.fc(feats)
        return feats.float()


# --------------------------------------------------------------- Task glue
def module_fields(module_cls: type) -> tuple[str, ...]:
    """The flax module's fields: ``module_cls``'s keyword-only arguments."""
    return tuple(name for name, p in inspect.signature(module_cls).parameters.items()
                 if p.kind is inspect.Parameter.KEYWORD_ONLY)


class ZooTask(Task):
    """A zoo model as a task: ``[model.<name>]`` sets the module's fields
    (lists become tuples), ``lr`` (default 1e-4) and ``use_probabilities``;
    cross entropy on integer labels; ``adam(lr)``; batches are (input,
    labels) with the input the first of ``input_keys`` the batch holds.

    The module does not exist until ``init(batch)`` sizes it from a host
    batch (``to_tensor``'s arrays) and draws its weights from the
    constructor's ``generator``; ``module`` raises before that."""

    module_cls: type
    input_keys: tuple[str, ...]

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        self.mc = dict(cfg["model"].get(self.name, {}) or {})
        self.device = resolve_device(device)
        self.generator = generator
        self._module: nn.Module | None = None

    @property
    def module(self) -> nn.Module:
        if self._module is None:
            raise RuntimeError(f"{self.name}: call task.init(batch) first; the model is sized "
                               "from its first batch")
        return self._module

    def module_kwargs(self) -> dict:
        fields = module_fields(self.module_cls)
        kwargs = {k: (tuple(v) if isinstance(v, list) else v)
                  for k, v in self.mc.items() if k in fields}
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = getattr(torch, kwargs["dtype"])
        kwargs.setdefault("dtype", self.compute_dtype())
        return kwargs

    def init(self, batch: tuple[np.ndarray, ...]) -> nn.Module:
        """The module sized from ``batch[0]``'s sample shape (built once)."""
        if self._module is None:
            module = self.module_cls(tuple(np.shape(batch[0])[1:]), **self.module_kwargs())
            self._module = init_weights(module, self.generator).to(self.device)
        return self._module

    def loss(self, batch, train: bool = True, kernels: bool = True):
        x, labels = batch[0], batch[1]
        self.module.train(train)
        logits = self.module(x, kernels=kernels)
        loss = cross_entropy(logits, labels)
        return loss, {"metrics": {"loss": loss}, "logits": logits}

    def predict(self, batch, kernels: bool = True):
        self.module.eval()
        return maybe_softmax(self.module(batch[0], kernels=kernels),
                             bool(self.mc.get("use_probabilities", False)))

    def make_optimizer(self, params):
        return adam(params, float(self.mc.get("lr", 1e-4)))

    @classmethod
    def to_tensor(cls, data_dict: dict) -> tuple[np.ndarray, ...]:
        data = data_dict["data"]
        for key in cls.input_keys:
            if key in data:
                x = np.asarray(data[key], np.float32)
                break
        else:
            raise KeyError(f"{cls.name} batch needs one of {cls.input_keys}; "
                           f"got keys {sorted(data)}")
        return x, np.asarray(data.get("label", []), np.int64)


SPEC_KEYS = ("flux", "spectrum", "spectra", "x")
# the timm-style spectra baselines consume 2-D spectra renders (images)
RENDER_KEYS = ("spectrum_image", "image", "x")
ZOO = {
    "BTSModel": (BTSModel, ("image", "x")),
    "GalSpecNet": (GalSpecNet, SPEC_KEYS),
    "MetaModel": (MetaModel, ("metadata", "meta19", "x")),
    "Informer": (Informer, ("photometry", "events", "x")),
    "SpectraViT": (SpectraViT, RENDER_KEYS),
    "SpectraEfficientNetV2": (SpectraEfficientNetV2, RENDER_KEYS),
    "SpectraConvNeXt": (SpectraConvNeXt, RENDER_KEYS),
}
for _name, (_cls, _keys) in ZOO.items():
    _task = type(f"{_name}Task", (ZooTask,), {"name": _name, "module_cls": _cls,
                                              "input_keys": _keys, "__module__": __name__})
    register_model(_task, name=_name)
    register_model(_task, name=f"applecider_tpu.models.zoo.{_name}Task")
