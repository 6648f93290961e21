"""1-D convolution and pooling for SpectraNet and its TriPool variant.

Counterpart of the direct path and the three pools (``max_pool1d``,
``avg_pool1d``, ``min_pool1d``) of ``applecider_tpu/ops/conv1d.py``. The JAX package leaves this convolution
to XLA outside any Pallas kernel, so here it is cuDNN's through
``torch.nn.functional.conv1d``. The FFT and space-to-depth routes of the
JAX package are TPU/CPU routing choices and are not ported.

Public layouts follow the JAX package: activations are (B, L, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d_ncl(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None
               ) -> torch.Tensor:
    """'same' cross-correlation, odd K, channels-first.

    x (B, Cin, L); weight (Cout, Cin, K) -> (B, Cout, L). The product runs in
    x's dtype; the bias is added after it as given, so an f32 bias lifts a
    bf16 product to f32 (the JAX package's type promotion).
    """
    k = weight.shape[-1]
    if k % 2 != 1:
        raise ValueError(f"'same' conv1d needs an odd kernel, got {k}")
    y = F.conv1d(x, weight.to(x.dtype), padding=k // 2)
    return y if bias is None else y + bias[:, None]


def conv1d_direct(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """'same' cross-correlation, odd K: x (B, L, Cin) -> (B, L, Cout)."""
    return conv1d_ncl(x.transpose(1, 2), weight, bias).transpose(1, 2)


def max_pool1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """torch MaxPool1d(window) semantics over L of (B, L, C): stride =
    window, no padding, the ragged tail dropped (floor)."""
    B, L, C = x.shape
    n = L // window
    return x[:, : n * window].reshape(B, n, window, C).amax(dim=2)


def avg_pool1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """torch AvgPool1d(window) semantics over L of (B, L, C): the window's
    sum divided by the window, in x's dtype, the ragged tail dropped."""
    B, L, C = x.shape
    n = L // window
    return x[:, : n * window].reshape(B, n, window, C).sum(dim=2) / window


def min_pool1d(x: torch.Tensor, window: int) -> torch.Tensor:
    """The TriPool's min pool, ``-max_pool1d(-x)``, as the JAX package
    computes it."""
    return -max_pool1d(-x, window)
