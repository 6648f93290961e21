"""K2: eval-path masked self-attention.

Counterpart of ``applecider_tpu/ops/attention.py``. ``masked_attention``
launches the hand-written kernel ``csrc/attention.cu`` on CUDA tensors and
runs the plain PyTorch version ``masked_attention_reference`` on CPU
tensors; any other device raises. Both follow the TPU kernel's numerics:
1/sqrt(hd) folded into q in f32, -1e9 added at padded keys, an f32 softmax
with max subtraction, the unnormalised P rounded to the I/O dtype before
P.V, and each row divided by its f32 sum at the end. The bf16 kernel runs
its products on the tensor cores and applies the scale to the f32 scores
after q.K^T, so the plain version holds it unchanged; the f32 kernel runs on
the FMA units.
"""

from __future__ import annotations

import ctypes
import math

import torch

from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_aligned, require_cuda

KERNEL = CudaKernel(
    "attention", "ac_masked_attention",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int],
)
HEAD_DIMS = (8, 16, 32)  # head widths the kernel is built for


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               key_padding_mask: torch.Tensor | None) -> torch.Tensor:
    """Plain PyTorch version. q/k/v (B, H, L, hd); mask (B, L) bool, True = pad."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float() * scale
    scores = torch.matmul(qf, k.float().transpose(-1, -2))
    if key_padding_mask is not None:
        neg = torch.where(key_padding_mask, -1e9, 0.0).to(torch.float32)
        scores = scores + neg[:, None, None, :]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(q.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_padding_mask: torch.Tensor | None) -> torch.Tensor:
    """(B, H, L, hd) attention; kernel K2 on CUDA, the plain version on CPU."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, key_padding_mask)
    tensors = (q, k, v) if key_padding_mask is None else (q, k, v, key_padding_mask)
    dev = require_cuda(*tensors)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, H, L, hd) shape: {q.shape}, {k.shape}, {v.shape}")
    B, H, L, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not built; the kernel takes {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v must share one dtype")
    code = dtype_code(q.dtype)
    if key_padding_mask is not None:
        if key_padding_mask.shape != (B, L) or key_padding_mask.dtype != torch.bool:
            raise ValueError(f"mask must be (B, L) bool, got {key_padding_mask.shape} "
                             f"{key_padding_mask.dtype}")
        if not key_padding_mask.is_contiguous():
            raise ValueError("mask must be contiguous")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q/k/v must be contiguous")
    if q.dtype == torch.bfloat16:
        require_aligned(q, k, v)
    out = torch.empty_like(q)
    mask_ptr = None if key_padding_mask is None else key_padding_mask
    KERNEL.launch(dev, q, k, v, mask_ptr, out, B, H, L, hd, 1.0 / math.sqrt(hd), code)
    return out
