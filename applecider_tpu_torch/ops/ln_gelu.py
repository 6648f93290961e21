"""K3: fused LayerNorm (last dim) + exact GELU, forward (K3f) and backward (K3b).

Counterpart of ``applecider_tpu/ops/ln_gelu.py``. ``ln_gelu`` is a
``torch.autograd.Function`` over the two kernel wrappers:

* ``ln_gelu_forward`` launches ``ac_ln_gelu_fwd`` (``csrc/ln_gelu.cu``) on a
  CUDA tensor and runs ``ln_gelu_reference`` on a CPU tensor; statistics and
  GELU are f32, the result is rounded once to the input dtype;
* ``ln_gelu_backward`` launches ``ac_ln_gelu_bwd`` on a CUDA tensor and runs
  ``ln_gelu_backward_reference`` on a CPU tensor: everything is recomputed
  from x in f32, dx comes out in x's dtype, and the kernel's per-block f32
  partial rows of dscale and dbias are summed here with ``torch.sum``, as
  the JAX package sums its per-block partials outside the kernel.

Any other device raises. ``kernels=False`` selects the plain versions on
any device (the yardstick ``chip_smoke.py`` compares the path with).
"""

from __future__ import annotations

import ctypes
import math

import torch

from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_cuda

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
BWD_ROWS = 64  # rows per block of the backward kernel: one partial row each

KERNEL = CudaKernel(
    "ln_gelu", "ac_ln_gelu_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int],
)
KERNEL_BWD = CudaKernel(
    "ln_gelu", "ac_ln_gelu_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int],
)


def ln_gelu_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: f32 LN over the last dim, then exact GELU."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    z = (xf - mean) * inv * scale.float() + bias.float()
    return (0.5 * z * (1.0 + torch.erf(z / _SQRT2))).to(x.dtype)


def ln_gelu_backward_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               g: torch.Tensor, eps: float = 1e-5
                               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward, the closed form of the JAX
    package's ``_bwd_kernel``: (dx in x's dtype, dscale, dbias in f32)."""
    xf = x.float()
    s = scale.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * inv
    z = xhat * s + bias.float()
    dgelu = 0.5 * (1.0 + torch.erf(z / _SQRT2)) + z * _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
    dz = g.float() * dgelu
    lead = tuple(range(x.dim() - 1))
    dscale = torch.sum(dz * xhat, dim=lead)
    dbias = torch.sum(dz, dim=lead)
    dxhat = dz * s
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (inv * (dxhat - m1 - xhat * m2)).to(x.dtype), dscale, dbias


def _check_vectors(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},), got {scale.shape}, {bias.shape}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale/bias must be float32")
    return C


def ln_gelu_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LN+GELU over the last dim of ``x``; kernel K3f on CUDA, plain on CPU."""
    if x.device.type == "cpu":
        return ln_gelu_reference(x, scale, bias, eps)
    dev = require_cuda(x, scale, bias)
    C = _check_vectors(x, scale, bias)
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("ln_gelu takes contiguous tensors")
    code = dtype_code(x.dtype)
    y = torch.empty_like(x)
    KERNEL.launch(dev, x, scale, bias, y, x.numel() // max(C, 1), C, float(eps), code)
    return y


def ln_gelu_backward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dscale, dbias) of LN+GELU; kernel K3b on CUDA, plain on CPU."""
    if x.device.type == "cpu":
        return ln_gelu_backward_reference(x, scale, bias, g, eps)
    dev = require_cuda(x, scale, bias, g)
    C = _check_vectors(x, scale, bias)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"g must match x: {g.shape} {g.dtype} vs {x.shape} {x.dtype}")
    if not all(t.is_contiguous() for t in (x, scale, bias, g)):
        raise ValueError("ln_gelu_backward takes contiguous tensors")
    code = dtype_code(x.dtype)
    N = x.numel() // max(C, 1)
    dx = torch.empty_like(x)
    blocks = -(-N // BWD_ROWS)
    ds_part = torch.empty((blocks, C), dtype=torch.float32, device=dev)
    db_part = torch.empty((blocks, C), dtype=torch.float32, device=dev)
    KERNEL_BWD.launch(dev, x, scale, bias, g, dx, ds_part, db_part, N, C, float(eps), code)
    return dx, torch.sum(ds_part, dim=0), torch.sum(db_part, dim=0)


class _LnGelu(torch.autograd.Function):
    """Keeps only x, scale and bias for the backward, which recomputes the
    rest, as the JAX package's custom VJP does."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, kernels):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.kernels = eps, kernels
        return (ln_gelu_forward if kernels else ln_gelu_reference)(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        fn = ln_gelu_backward if ctx.kernels else ln_gelu_backward_reference
        dx, dscale, dbias = fn(x, scale, bias, g.contiguous(), ctx.eps)
        return dx, dscale, dbias, None, None


def ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
            kernels: bool = True) -> torch.Tensor:
    """LN+GELU over the last dim of ``x``, differentiable in x, scale and
    bias: K3f forward and K3b backward on CUDA tensors (``kernels=True``),
    the plain versions on CPU tensors or with ``kernels=False``."""
    return _LnGelu.apply(x, scale, bias, float(eps), bool(kernels))
