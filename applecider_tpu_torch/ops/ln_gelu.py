"""K3: fused LayerNorm (last dim) + exact GELU, forward (K3f) and backward (K3b).

Counterpart of ``applecider_tpu/ops/ln_gelu.py``. ``ln_gelu`` is a
``torch.autograd.Function`` over the two kernel wrappers:

* ``ln_gelu_forward`` calls the custom op ``applecider_torch::ln_gelu_fwd``,
  which launches ``ac_ln_gelu_fwd`` (``csrc/ln_gelu.cu``) on a CUDA tensor
  and runs ``ln_gelu_reference`` on a CPU tensor, and stays one node of a
  ``torch.export`` graph; statistics and GELU are f32, the result is
  rounded once to the input dtype;
* ``ln_gelu_backward`` launches ``ac_ln_gelu_bwd`` on a CUDA tensor and runs
  ``ln_gelu_backward_reference`` on a CPU tensor: everything is recomputed
  from x in f32, dx comes out in x's dtype, and the kernel's per-block f32
  partial rows of dscale and dbias are summed here with ``torch.sum``, as
  the JAX package sums its per-block partials outside the kernel (one
  ``torch.sum`` for both). Its launch geometry is ``bwd_geometry(N, C)``.

Any other device raises. ``kernels=False`` selects the plain versions on
any device (the yardstick ``chip_smoke.py`` compares the path with).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from applecider_tpu_torch.ops.kernel import (
    CudaKernel, dtype_code, require_cpu_or_cuda, require_cuda,
)

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
BWD_THREADS = 512  # a block of the backward kernel (csrc/ln_gelu.cu kBwdThreads)
BWD_CHUNKS = (3, 8)  # the chunk counts a thread can hold (the compiled instantiations)
BWD_SMS = 132  # SMs of an H100 SXM: the grid is at most one wave of resident blocks

KERNEL = CudaKernel(
    "ln_gelu", "ac_ln_gelu_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int],
)
KERNEL_BWD = CudaKernel(
    "ln_gelu", "ac_ln_gelu_bwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
)


class BwdGeometry(NamedTuple):
    """Launch geometry of K3b: a row group of ``warps`` warps holds a row,
    each of its threads ``chunks`` vectors of ``vec`` elements; a block of
    ``BWD_THREADS`` threads holds ``groups`` row groups, and the grid
    ``blocks`` blocks, one partial row of dscale and dbias each. ``chunks``
    0 is the wide path: a block is one row group that streams its row from
    device memory, one element a thread at a time."""

    vec: int
    warps: int
    chunks: int
    blocks: int

    @property
    def groups(self) -> int:
        return BWD_THREADS // (32 * self.warps)


def bwd_geometry(N: int, C: int, vec: int = 2) -> BwdGeometry:
    """K3b's launch geometry for N rows of C columns, a function of (N, C)
    alone (and of ``vec``: 2 where C is even and the rows aligned, else 1).

    The group is the fewest warps, at most 16, whose threads cover the row
    in 3 vectors each: at every SpectraNet width 192 * 2^k that is 2^k
    warps and 6 f32 a thread. A wider row takes 8 vectors a thread (C <=
    8192, or 4096 with vec 1), and a wider one still the wide path. The
    grid is the blocks the rows need, capped at one wave: 2 blocks an SM
    with 3 vectors a thread (ptxas fits them in 64 registers) or on the
    wide path, else 1.
    """
    vec = vec if C % 2 == 0 else 1
    n_vec = -(-C // vec)
    warps = 1
    while warps < 16 and 32 * warps * 3 < n_vec:
        warps *= 2
    fits = [k for k in BWD_CHUNKS if 32 * warps * k >= n_vec]
    if not fits:
        return BwdGeometry(1, 16, 0, min(N, 2 * BWD_SMS))
    chunks = fits[0]
    groups = BWD_THREADS // (32 * warps)
    blocks = min(-(-N // groups), BWD_SMS * (2 if chunks == 3 else 1))
    return BwdGeometry(vec, warps, chunks, blocks)


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
    require_cpu_or_cuda(x, scale, bias)
    return ln_gelu_fwd_op(x, scale, bias, float(eps))


@torch.library.custom_op("applecider_torch::ln_gelu_fwd", mutates_args=(), device_types="cuda")
def ln_gelu_fwd_op(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """K3f on CUDA tensors (the CPU's implementation is ``ln_gelu_reference``)."""
    dev = require_cuda(x, scale, bias)
    C = _check_vectors(x, scale, bias)
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("ln_gelu takes contiguous tensors")
    code = dtype_code(x.dtype)
    y = torch.empty_like(x)
    KERNEL.launch(dev, x, scale, bias, y, x.numel() // max(C, 1), C, float(eps), code)
    return y


ln_gelu_fwd_op.register_kernel("cpu")(ln_gelu_reference)


@ln_gelu_fwd_op.register_fake
def _(x, scale, bias, eps):
    return torch.empty_like(x)


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
    aligned = all(t.data_ptr() % (2 * t.element_size()) == 0 for t in (x, scale, bias, g))
    geo = bwd_geometry(N, C, 2 if aligned else 1)
    part = torch.empty((2, geo.blocks, C), dtype=torch.float32, device=dev)  # dscale's, dbias'
    KERNEL_BWD.launch(dev, x, scale, bias, g, dx, part[0], part[1], N, C, float(eps), code,
                      geo.vec, geo.warps, geo.chunks, geo.blocks)
    sums = torch.sum(part, dim=1)
    return dx, sums[0], sums[1]


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
