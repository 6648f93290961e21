"""Shared layers with the JAX package's numerics.

Counterparts of ``applecider_tpu/models/layers.py``. Parameters are kept in
f32, under the flax names (``kernel`` becomes ``weight``, LayerNorm's
``scale`` becomes ``weight``), and cast to a layer's compute ``dtype`` where
it is used, as flax does. ``dtype=None`` follows flax's ``astype(None)``:
Linear computes in f32, LayerNorm returns its input's dtype.

Modules that hold a kernel take ``kernels`` in their forward: True (the
default) calls the kernel wrapper, which launches the hand-written kernel on
a CUDA tensor; False calls the plain PyTorch version directly, the
yardstick that ``chip_smoke.py`` compares the path with.

Dropout sites are live in ``train()`` mode, as flax's are with
``deterministic=False``; they draw from the ``DropoutRNG`` that
``ops.dropout.attach_dropout_rng`` gives them.

The dense layer and the convolutions (``convnext.Conv2dTorch``,
``spectranet.Conv1d``) hold the hook of ``ops.quant``: inside
``quantized(scales)`` a layer with a scale computes in int8.

``TransformerEncoder(remat=...)`` is the JAX encoder's backward
rematerialisation, set by ``model.BaselineCLS.remat`` through
``resolve_remat``: a memory knob, not a speed knob.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.ops.attention import masked_attention, masked_attention_reference
from applecider_tpu_torch.ops.dropout import (
    SEED_BOUND, DropoutRNG, FastDropout, checkpoint, dropout_rngs,
)
from applecider_tpu_torch.ops.flash_attention import flash_attention
from applecider_tpu_torch.ops.ln_gelu import ln_gelu
from applecider_tpu_torch.ops.quant import quant_dense


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``, in module order,
    with the torch-default initialisers the JAX package copies."""
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
    return module


class Linear(nn.Module):
    """Dense layer: ``x.to(dtype) @ W.to(dtype) + b.to(dtype)``, f32 when
    ``dtype`` is None; the bias is added after the product is rounded."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / math.sqrt(self.in_features)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = quant_dense(x, self)  # the opt-in int8 serving path; None unless ops.quant is on
        if q is not None:
            return q
        dt = self.dtype or torch.float32
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with f32 statistics; returns ``dtype``
    (or the input's dtype when None)."""

    def __init__(self, features: int, eps: float = 1e-5, dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype or x.dtype)


class LayerNormGelu(LayerNorm):
    """LayerNorm followed by exact GELU in one pass: kernel K3 forward, and
    K3 backward under autograd.

    Same parameters as LayerNorm. Follows the JAX package's fused path: the
    GELU is computed in f32 before the single rounding to the output dtype.
    """

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        y = ln_gelu(x.contiguous(), self.weight, self.bias, self.eps, kernels=kernels)
        return y.to(self.dtype or x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


class MultiHeadSelfAttention(nn.Module):
    """Fused-qkv self-attention with a key-padding mask (True = padded).

    While autograd records (q requires grad), the attention is kernel K4,
    which has a backward: with dropout at ``dropout`` in ``train()`` mode and
    at 0 in ``eval()`` mode, its Philox seed a host integer drawn from
    ``dropout_rng.cpu``, one per call, as flax draws one per layer. Without
    autograd it is kernel K2, the serving kernel, which has no backward.
    """

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.dropout_rng: DropoutRNG | None = None
        self.in_proj = Linear(d_model, 3 * d_model, dtype=dtype)
        self.out_proj = Linear(d_model, d_model, dtype=dtype)

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor | None = None,
                kernels: bool = True) -> torch.Tensor:
        B, L, D = x.shape
        H = self.num_heads
        q, k, v = (t.reshape(B, L, H, D // H).transpose(1, 2).contiguous()
                   for t in self.in_proj(x).split(D, dim=-1))
        mask = None if key_padding_mask is None else key_padding_mask.contiguous()
        if q.requires_grad:
            rate = self.dropout if self.training else 0.0
            gen = None if self.dropout_rng is None else self.dropout_rng.cpu
            seed = int(torch.randint(0, SEED_BOUND, (1,), generator=gen)) if rate > 0.0 else 0
            out = flash_attention(q, k, v, mask, seed, rate, kernels=kernels)
        else:
            out = (masked_attention if kernels else masked_attention_reference)(q, k, v, mask)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class TransformerEncoderLayer(nn.Module):
    """Post-LN block (torch ``nn.TransformerEncoderLayer`` defaults, ReLU):
    x = LN1(x + Drop(attn(x))); x = LN2(x + Drop(W2 Drop(relu(W1 x))))."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.self_attn = MultiHeadSelfAttention(d_model, num_heads, dropout, dtype=dtype)
        self.attn_drop = FastDropout(dropout)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, dtype=dtype)
        self.ffn_drop = FastDropout(dropout)
        self.linear2 = Linear(dim_feedforward, d_model, dtype=dtype)
        self.out_drop = FastDropout(dropout)
        self.norm2 = LayerNorm(d_model, dtype=dtype)

    def forward(self, x, key_padding_mask=None, kernels: bool = True):
        x = self.norm1(x + self.attn_drop(self.self_attn(x, key_padding_mask, kernels=kernels)))
        h = self.out_drop(self.linear2(self.ffn_drop(torch.relu(self.linear1(x)))))
        return self.norm2(x + h)


class TransformerEncoder(nn.Module):
    """Stack of post-LN layers ``layer_0 .. layer_{n-1}``, no final norm.

    ``remat`` (``resolve_remat``'s values):

    * False: every activation the backward needs is kept.
    * True: each layer runs under ``ops.dropout.checkpoint``, a
      non-reentrant activation checkpoint, and the backward recomputes the
      layer from its input, drawing the same K4 seeds and dropout bits
      again. The first pass stays under autograd, so it keeps K4 and its
      dropout.
    * "attn": the layers run as with False. The JAX policy drops only the
      (B, H, L, L) scores, probabilities and dropout tensors from the saved
      set, and those exist only on its XLA attention. Here the attention
      under autograd is always K4 (``_Flash``), on the card and on the CPU:
      it saves q, k, v, the mask and the bit source, and its backward
      recomputes the probabilities, so no (B, H, L, L) tensor is ever saved,
      which is what "attn" asks for.

    Where autograd does not record the layer (serving, evaluation, a frozen
    module: its input does not require grad) True changes nothing, as the
    attention routes by the same test.
    """

    def __init__(self, num_layers: int, d_model: int, num_heads: int, dim_feedforward: int,
                 dropout: float = 0.0, dtype: torch.dtype | None = None, remat=False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = resolve_remat(remat)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, num_heads, dim_feedforward, dropout, dtype=dtype))

    def forward(self, x, key_padding_mask=None, kernels: bool = True):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat is True and x.requires_grad:
                x = checkpoint(layer, x, key_padding_mask, kernels, rngs=dropout_rngs(layer))
            else:
                x = layer(x, key_padding_mask, kernels=kernels)
        return x


_REMAT_OFF = ("auto", "false", "0", "no", "off", "")
_REMAT_LAYER = ("true", "1", "yes", "layer")


def resolve_remat(value):
    """A ``model.*.remat`` value as False, True or "attn", as the JAX
    package resolves it: "auto" (the default) is False, "true", "yes", "1"
    and "layer" are True. A value it would read as something else raises
    here rather than being ignored."""
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in _REMAT_OFF:
        return False
    if v in _REMAT_LAYER:
        return True
    if v == "attn":
        return "attn"
    raise ValueError(f"remat = {value!r}: expected true, false, \"auto\" or \"attn\"")
