"""K3 forward: fused LayerNorm (last dim) + exact GELU.

Counterpart of the forward half of ``applecider_tpu/ops/ln_gelu.py``.
``ln_gelu`` launches the hand-written kernel ``csrc/ln_gelu.cu`` on a CUDA
tensor and runs the plain PyTorch version ``ln_gelu_reference`` on a CPU
tensor; any other device raises. Statistics and GELU are f32, the result
is rounded once to the input dtype.
"""

from __future__ import annotations

import ctypes
import math

import torch

from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_cuda

_SQRT2 = math.sqrt(2.0)

KERNEL = CudaKernel(
    "ln_gelu", "ac_ln_gelu_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_int],
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


def ln_gelu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """LN+GELU over the last dim of ``x``; kernel K3 on CUDA, plain on CPU."""
    if x.device.type == "cpu":
        return ln_gelu_reference(x, scale, bias, eps)
    dev = require_cuda(x, scale, bias)
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"scale/bias must be ({C},), got {scale.shape}, {bias.shape}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("scale/bias must be float32")
    if not (x.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("ln_gelu takes contiguous tensors")
    code = dtype_code(x.dtype)
    y = torch.empty_like(x)
    KERNEL.launch(dev, x, scale, bias, y, x.numel() // max(C, 1), C, float(eps), code)
    return y
