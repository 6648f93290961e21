"""K4: training-path self-attention with fused dropout, forward and backward.

Counterpart of ``applecider_tpu/ops/flash_attention.py``. The kernels
(``csrc/flash_attention.cu``) compute scores, softmax, dropout and P.V for
one (batch, head) pair on chip; the backward recomputes the (L, L) tile
from q, k, v and regenerates the dropout bits, so nothing larger than q, k
and v is kept for it. Public layouts follow the JAX package: q/k/v
(B, H, L, hd), ``key_padding_mask`` (B, L) bool with True = padded key.

Dropout semantics match ``ops/dropout.FastDropout``: keep iff a u8 draw is
>= ``thresh = round(rate * 256)``, kept entries scaled by
``256 / (256 - thresh)``. The bits come from a Philox4x32-10 counter
stream keyed on an integer seed (see ``dropout_bits_reference``); the TPU
kernels draw from the TPU core's PRNG instead. Only the keep rule and the
scale are contractual, not the stream.

Entry points:

* ``flash_attention(q, k, v, key_padding_mask, seed, rate)``: autograd
  function over the Philox kernels (K4a);
* ``flash_attention_export_mask(...)``: forward only, also returns the u8
  keep mask the kernel drew;
* ``flash_attention_with_bits(q, k, v, key_padding_mask, bits_u8, rate)``:
  autograd function over the injected-bits kernels (K4b), the replay target
  (pass ``keep * 255`` to reproduce a keep decision exactly).

The bf16 forward and backward kernels run their products on the tensor
cores, the f32 ones on the FMA units (``csrc/flash_attention.cu`` says
why); they are held to ``flash_attention_reference`` and
``flash_attention_backward_reference``.

Each launches its kernel on CUDA tensors and runs the plain versions
``flash_attention_reference`` / ``flash_attention_backward_reference`` on
CPU tensors; any other device raises. ``flash_attention(...,
kernels=False)`` selects the plain versions on any device, with the Philox
bits from ``dropout_bits_reference``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from applecider_tpu_torch.ops.attention import HEAD_DIMS
from applecider_tpu_torch.ops.dropout import drop_consts
from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_aligned, require_cuda

_NEG = -1e9

_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_uint32, ctypes.c_int]
_BWD_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_uint32, ctypes.c_int]
KERNEL_FWD = CudaKernel("flash_attention", "ac_flash_fwd", _FWD_ARGS)
KERNEL_BWD = CudaKernel("flash_attention", "ac_flash_bwd", _BWD_ARGS)

# Philox4x32-10 constants (Salmon et al., SC'11)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _drop_consts(rate: float) -> tuple[int, float]:
    """(integer threshold, inverted keep scale): FastDropout semantics."""
    thresh, scale = drop_consts(rate)
    if thresh >= 256:
        raise ValueError("flash attention does not support rate ~= 1 (drop-all)")
    return thresh, scale


def _mulhilo(a: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of ``a * x`` for a 32-bit constant ``a``
    and int64 ``x`` holding 32-bit values, without overflowing int64."""
    p_lo = a * (x & 0xFFFF)
    p_hi = a * (x >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def dropout_bits_reference(seed: int, B: int, H: int, L: int, device=None) -> torch.Tensor:
    """The (B, H, L, L) u8 draws the K4 kernels use for ``seed``, computed
    with int64 tensor arithmetic.

    Element e = ((b*H + h)*L + i)*L + j takes the low byte of word e % 4 of
    Philox4x32-10 keyed on (seed, 0) at counter (e / 4 mod 2^32, e / 2^34,
    0, 0): ten rounds of ``(x0, x1, x2, x3) <- (hi(M1*x2) ^ x1 ^ k0,
    lo(M1*x2), hi(M0*x0) ^ x3 ^ k1, lo(M0*x0))`` with the key bumped by
    (W0, W1) between rounds.
    """
    n = B * H * L * L
    c = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    x0, x1 = c & _MASK32, c >> 32
    x2 = torch.zeros_like(c)
    x3 = torch.zeros_like(c)
    k0, k1 = int(seed) & _MASK32, 0
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, x0)
        hi1, lo1 = _mulhilo(_M1, x2)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    words = torch.stack((x0, x1, x2, x3), dim=-1).reshape(-1)[:n]
    return (words & 0xFF).to(torch.uint8).reshape(B, H, L, L)


def _neg(key_padding_mask: torch.Tensor | None) -> torch.Tensor | float:
    if key_padding_mask is None:
        return 0.0
    return torch.where(key_padding_mask, _NEG, 0.0).to(torch.float32)[:, None, None, :]


def _scores(q, k, key_padding_mask):
    """f32 masked scores of the kernels: q scaled in f32 and rounded to the
    I/O dtype, f32 products, -1e9 at padded keys."""
    qs = (q.float() * (1.0 / math.sqrt(q.shape[-1]))).to(q.dtype).float()
    return torch.matmul(qs, k.float().transpose(-1, -2)) + _neg(key_padding_mask)


def _probs(q, k, key_padding_mask):
    """f32 (p_un, denom) of the kernels: the softmax statistics of
    ``_scores``."""
    scores = _scores(q, k, key_padding_mask)
    p_un = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return p_un, p_un.sum(dim=-1, keepdim=True)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              key_padding_mask: torch.Tensor | None, keep: torch.Tensor | None,
                              rate: float) -> torch.Tensor:
    """Plain forward, ``_fwd_pair``'s numerics: the pre-dropout denominator;
    kept ``p_un * drop_scale`` (0 elsewhere) rounded to the I/O dtype before
    P.V; ``keep`` (B, H, L, L) bool, or None for no dropout."""
    _, drop_scale = _drop_consts(rate)
    p_un, denom = _probs(q, k, key_padding_mask)
    if keep is not None:
        p_un = torch.where(keep, p_un * drop_scale, 0.0)
    pv = torch.matmul(p_un.to(q.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def flash_attention_backward_reference(q, k, v, key_padding_mask, keep, rate: float, dout
                                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, ``_bwd_pair``'s numerics: (dq, dk, dv) in q's dtype."""
    io = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, drop_scale = _drop_consts(rate)
    p_un, denom = _probs(q, k, key_padding_mask)
    p = p_un / denom
    pd = p if keep is None else torch.where(keep, p * drop_scale, 0.0)
    dof = dout.float()
    dv = torch.matmul(pd.to(io).float().transpose(-1, -2), dof)
    dpd = torch.matmul(dof.to(io).float(), v.float().transpose(-1, -2))
    dp = dpd if keep is None else torch.where(keep, dpd * drop_scale, 0.0)
    t = torch.sum(dp * p, dim=-1, keepdim=True)
    dsc = (p * (dp - t)).to(io).float()
    dq = torch.matmul(dsc, k.float()) * scale
    qk = ((q.float() * scale) / scale).to(io).float()
    dk = torch.matmul(dsc.transpose(-1, -2), qk) * scale
    return dq.to(io), dk.to(io), dv.to(io)


def _check(q, k, v, key_padding_mask, *extra) -> torch.device:
    tensors = [t for t in (q, k, v, key_padding_mask, *extra) if t is not None]
    dev = require_cuda(*tensors)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, H, L, hd) shape: {q.shape}, {k.shape}, {v.shape}")
    B, H, L, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head width {hd} not built; the kernels take {HEAD_DIMS}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q/k/v must share one dtype")
    if key_padding_mask is not None and (key_padding_mask.shape != (B, L)
                                         or key_padding_mask.dtype != torch.bool):
        raise ValueError(f"mask must be (B, L) bool, got {key_padding_mask.shape} "
                         f"{key_padding_mask.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention takes contiguous tensors")
    return dev


def _cpu_keep(q, seed, bits, thresh):
    """The keep mask of a plain-version call: from ``bits`` or the Philox
    twin; None when nothing is dropped."""
    if thresh == 0:
        return None
    if bits is None:
        B, H, L, _ = q.shape
        bits = dropout_bits_reference(seed, B, H, L, device=q.device)
    return bits >= thresh


def flash_forward(q, k, v, key_padding_mask, rate: float, seed: int = 0, bits=None,
                  export: bool = False, kernels: bool = True):
    """Forward of K4: out, or (out, keep u8) with ``export``. Bits come from
    ``bits`` (B, H, L, L) u8 when given, else from Philox keyed on ``seed``."""
    thresh, drop_scale = _drop_consts(rate)
    if q.device.type == "cpu" or not kernels:
        keep = _cpu_keep(q, seed, bits, thresh)
        out = flash_attention_reference(q, k, v, key_padding_mask, keep, rate)
        if not export:
            return out
        keep_u8 = (torch.ones(q.shape[:3] + (q.shape[2],), dtype=torch.uint8, device=q.device)
                   if keep is None else keep.to(torch.uint8))
        return out, keep_u8
    dev = _check(q, k, v, key_padding_mask, bits)
    if q.dtype == torch.bfloat16:
        require_aligned(q, k, v)
    B, H, L, hd = q.shape
    if bits is not None and (bits.shape != (B, H, L, L) or bits.dtype != torch.uint8):
        raise ValueError(f"bits must be (B, H, L, L) uint8, got {bits.shape} {bits.dtype}")
    out = torch.empty_like(q)
    keep_u8 = torch.empty((B, H, L, L), dtype=torch.uint8, device=dev) if export else None
    KERNEL_FWD.launch(dev, q, k, v, key_padding_mask, bits, out, keep_u8, B, H, L, hd,
                      1.0 / math.sqrt(hd), thresh, drop_scale, int(seed) & 0xFFFFFFFF,
                      dtype_code(q.dtype))
    return (out, keep_u8) if export else out


def flash_backward(q, k, v, key_padding_mask, rate: float, dout, seed: int = 0, bits=None,
                   kernels: bool = True):
    """Backward of K4: (dq, dk, dv), regenerating the forward's bits."""
    thresh, drop_scale = _drop_consts(rate)
    if q.device.type == "cpu" or not kernels:
        keep = _cpu_keep(q, seed, bits, thresh)
        return flash_attention_backward_reference(q, k, v, key_padding_mask, keep, rate, dout)
    dev = _check(q, k, v, key_padding_mask, bits, dout)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout must match q: {dout.shape} {dout.dtype}")
    B, H, L, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    KERNEL_BWD.launch(dev, q, k, v, key_padding_mask, bits, dout, dq, dk, dv, B, H, L, hd,
                      1.0 / math.sqrt(hd), thresh, drop_scale, int(seed) & 0xFFFFFFFF,
                      dtype_code(q.dtype))
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """Forward keeps q, k, v, the mask and the bit source (seed or bits);
    backward regenerates the bits and recomputes the tile."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, bits, seed, rate, kernels):
        ctx.save_for_backward(q, k, v, key_padding_mask, bits)
        ctx.seed, ctx.rate, ctx.kernels = seed, rate, kernels
        return flash_forward(q, k, v, key_padding_mask, rate, seed=seed, bits=bits, kernels=kernels)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_padding_mask, bits = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, key_padding_mask, ctx.rate, dout.contiguous(),
                                    seed=ctx.seed, bits=bits, kernels=ctx.kernels)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, key_padding_mask, seed: int, rate: float, kernels: bool = True):
    """(B, H, L, hd) attention with fused dropout drawn from Philox keyed on
    ``seed`` (a host integer); differentiable in q, k and v."""
    return _Flash.apply(q, k, v, key_padding_mask, None, int(seed), float(rate), bool(kernels))


def flash_attention_with_bits(q, k, v, key_padding_mask, bits_u8, rate: float):
    """The same math on injected u8 bits (keep iff bits >= round(rate*256))."""
    return _Flash.apply(q, k, v, key_padding_mask, bits_u8, 0, float(rate), True)


def flash_attention_export_mask(q, k, v, key_padding_mask, seed: int, rate: float):
    """Forward only; returns (out, keep u8) with the keep mask drawn."""
    return flash_forward(q, k, v, key_padding_mask, rate, seed=seed, export=True)
