"""int8 serving kernels: the input quantizer, the int8 GEMM, the int8
convolution and the depthwise int8 convolution, with the dequantizing
epilogue of ``ops.quant``.

No Pallas kernel stands behind these: the JAX package leaves its int8
products to XLA (``applecider_tpu/ops/quant.py``). Each wrapper launches its
hand-written kernel of ``csrc/int8.cu`` on CUDA tensors and runs its plain
PyTorch twin on CPU tensors; any other device raises, and nothing falls
back:

* ``quantize(x, inv)``: ``rint(x * inv)`` clamped to +-127, as int8
  (``ac_int8_quantize``);
* ``gemm(a, b, scale, bias, out_dtype)``: a (M, K) x b (N, K)^T in int32,
  then ``float(acc) * scale[n] (+ bias[n])`` in f32 and the output dtype
  (``ac_int8_gemm``);
* ``conv2d(x, w, scale, bias, out_dtype, stride, padding, groups)`` on an
  NHWC int8 image with an OIHW int8 weight: groups = 1 launches the
  implicit-GEMM ``ac_int8_conv``, groups = C (depthwise) ``ac_int8_dwconv``.

The GEMM and the implicit-GEMM convolution are one kernel on the int8
tensor cores (``csrc/int8.cu``'s note says how it tiles and loads); it
takes any K up to ``MAX_K`` and any alignment of the operands.

``out_dtype=torch.int32`` returns the int32 accumulators themselves (no
epilogue): the check of the products alone. The twins compute the
products in float64, exact for every integer sum below 2^53, and round
them to int32; their epilogue is the same f32 product and sum.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_cuda

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
KERNEL_QUANTIZE = CudaKernel("int8", "ac_int8_quantize", [_P, _P, _I64, ctypes.c_float, _I])
KERNEL_GEMM = CudaKernel("int8", "ac_int8_gemm", [_P, _P, _P, _P, _P, _I64, _I, _I, _I])
KERNEL_CONV = CudaKernel("int8", "ac_int8_conv", [_P, _P, _P, _P, _P, _I64] + [_I] * 13)
KERNEL_DWCONV = CudaKernel("int8", "ac_int8_dwconv", [_P, _P, _P, _P, _P, _I64] + [_I] * 12)
KERNELS = {"int8_quantize": KERNEL_QUANTIZE, "int8_gemm": KERNEL_GEMM, "int8_conv": KERNEL_CONV,
           "int8_dwconv": KERNEL_DWCONV}
MAX_K = 133_143  # the deepest K whose int32 sum of int8 products cannot overflow: K * 127^2 < 2^31


def _out_code(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.int32 else dtype_code(dtype)


# ----------------------------------------------------------------- twins
def quantize_reference(x: torch.Tensor, inv: float) -> torch.Tensor:
    """Plain version: ``rint(x_f32 * inv)`` half to even, clamped to +-127,
    as int8 (``inv`` an f32 value)."""
    return torch.round(x.float() * inv).clamp(-127, 127).to(torch.int8)


def epilogue_reference(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """``float(acc) * scale (+ bias)`` in f32 over the last dim, then
    ``out_dtype``; int32 returns ``acc`` as it is."""
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def gemm_reference(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None,
                   bias: torch.Tensor | None, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``gemm``: the exact int32 product in float64."""
    acc = F.linear(a.double(), b.double()).round().to(torch.int32)
    return epilogue_reference(acc, scale, bias, out_dtype)


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                     bias: torch.Tensor | None, out_dtype: torch.dtype, stride=(1, 1),
                     padding=(0, 0), groups: int = 1) -> torch.Tensor:
    """Plain version of ``conv2d``: the exact int32 convolution in float64,
    NHWC in and out."""
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(), stride=tuple(stride),
                   padding=tuple(padding), groups=groups)
    acc = acc.round().to(torch.int32).permute(0, 2, 3, 1)
    return epilogue_reference(acc, scale, bias, out_dtype).contiguous()


# -------------------------------------------------------------- wrappers
def quantize(x: torch.Tensor, inv: float) -> torch.Tensor:
    """int8 ``rint(x * inv)`` clamped to +-127 (x f32 or bf16, ``inv`` an f32
    value); kernel ``ac_int8_quantize`` on CUDA, the twin on the CPU."""
    if x.device.type == "cpu":
        return quantize_reference(x, inv)
    dev = require_cuda(x)
    x = x.contiguous()
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    KERNEL_QUANTIZE.launch(dev, x, q, x.numel(), float(inv), dtype_code(x.dtype))
    return q


def _check_epilogue(n: int, scale, bias, out_dtype) -> None:
    if out_dtype == torch.int32:
        return
    for what, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.shape != (n,) or t.dtype != torch.float32
                              or not t.is_contiguous()):
            raise ValueError(f"{what} must be a contiguous f32 ({n},), got {t.dtype} {t.shape}")
    if scale is None:
        raise ValueError("the epilogue needs a scale")


def gemm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
         out_dtype: torch.dtype) -> torch.Tensor:
    """(M, N) = epilogue(a (M, K) int8 x b (N, K) int8 ^T, accumulated in
    int32); kernel ``ac_int8_gemm`` on CUDA, the twin on the CPU."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"gemm takes (M, K) and (N, K), got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"gemm takes int8 operands, got {a.dtype} and {b.dtype}")
    if a.shape[1] > MAX_K:
        raise ValueError(f"K = {a.shape[1]} could overflow the int32 sum (at most {MAX_K})")
    if a.device.type == "cpu":
        return gemm_reference(a, b, scale, bias, out_dtype)
    dev = require_cuda(*(t for t in (a, b, scale, bias) if t is not None))
    (M, K), N = a.shape, b.shape[0]
    _check_epilogue(N, scale, bias, out_dtype)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    KERNEL_GEMM.launch(dev, a, b, scale, bias, out, M, N, K, _out_code(out_dtype))
    return out


def conv_output_size(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def conv2d(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None, bias: torch.Tensor | None,
           out_dtype: torch.dtype, stride=(1, 1), padding=(0, 0), groups: int = 1) -> torch.Tensor:
    """(B, Ho, Wo, Cout) = epilogue(conv of x (B, H, W, C) int8 with w
    (Cout, C / groups, kh, kw) int8, zero padding, int32 accumulation).
    On CUDA: ``ac_int8_conv`` for groups = 1, ``ac_int8_dwconv`` for
    groups = C = Cout; the twin on the CPU."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] * groups != x.shape[3]:
        raise ValueError(f"conv2d takes NHWC x and OIHW w, got {tuple(x.shape)}, {tuple(w.shape)} "
                         f"with groups {groups}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"conv2d takes int8 operands, got {x.dtype} and {w.dtype}")
    Cout, cin_g, kh, kw = w.shape
    if cin_g * kh * kw > MAX_K:
        raise ValueError(f"K = {cin_g * kh * kw} could overflow the int32 sum (at most {MAX_K})")
    if x.device.type == "cpu":
        return conv2d_reference(x, w, scale, bias, out_dtype, stride, padding, groups)
    dev = require_cuda(*(t for t in (x, w, scale, bias) if t is not None))
    B, H, W, C = x.shape
    (sh, sw), (ph, pw) = stride, padding
    Ho, Wo = conv_output_size(H, kh, sh, ph), conv_output_size(W, kw, sw, pw)
    _check_epilogue(Cout, scale, bias, out_dtype)
    x = x.contiguous()
    out = torch.empty((B, Ho, Wo, Cout), dtype=out_dtype, device=dev)
    if groups == 1:
        wk = w.permute(0, 2, 3, 1).contiguous()  # (Cout, kh, kw, C): k = (r, s, c)
        KERNEL_CONV.launch(dev, x, wk, scale, bias, out, B, H, W, C, Ho, Wo, Cout, kh, kw, sh, sw,
                           ph, pw, _out_code(out_dtype))
    elif groups == C == Cout:
        wk = w[:, 0].permute(1, 2, 0).contiguous()  # (kh, kw, C)
        KERNEL_DWCONV.launch(dev, x, wk, scale, bias, out, B, H, W, C, Ho, Wo, kh, kw, sh, sw, ph,
                             pw, _out_code(out_dtype))
    else:
        raise ValueError(f"the int8 kernels take groups = 1 or depthwise (groups = C = Cout), got "
                         f"groups {groups} with C {C}, Cout {Cout}")
    return out
