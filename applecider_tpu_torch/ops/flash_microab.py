"""K4x: the forward ablation ladder of K4, the training attention.

Counterpart of the kernel half of ``scripts/tpu_flash_microab.py``
(``_fwd_kernel``, ``_fwd_kernel_batched``). Each rung is K4's forward with
stages taken out, so that timing the rungs splits that forward's time
between the products, the softmax, the dropout draw and its application.
The rungs are the forward the training step runs in each dtype: in bf16
the tensor-core forward (``flash_fwd_mma_kernel``), in f32 the FMA one
(``flash_fwd_kernel``); ``route`` names the kernel of each rung.

* ``full``: K4a's forward, Philox dropout keyed on ``seed``: the very
  kernel ``flash_attention.flash_forward(seed=)`` launches, so its output
  equals that call's bit for bit;
* ``no_prng``: the same without dropout (K4's keep-all forward,
  ``flash_forward`` at rate 0);
* ``prng_only_no_apply``: ``no_prng`` plus the keep mask drawn and not
  applied; its output equals ``no_prng``'s. In bf16 the draw is the Philox
  counters and the fill of the tile's keep bytes, in ``full``'s shared
  memory, so that ``full - prng_only_no_apply`` is only the apply (the
  keep bit's select and the scale);
* ``matmul_only``: no max, ``exp`` or denominator: the raw masked scores
  (-1e9 included) rounded to the I/O dtype, times V, undivided. Outputs of
  order 1e9 are the contract;
* ``batched4``, ``batched8``: ``no_prng`` computed for 4 or 8 heads of one
  batch row per block (``pair_block`` must divide H); its output equals
  ``no_prng``'s.

Layouts follow ``ops/flash_attention.py``: q/k/v (B, H, L, hd)
contiguous, ``key_padding_mask`` (B, L) bool with True = padded key. The
wrapper launches the kernel (``csrc/flash_attention.cu``
``ac_flash_fwd_ablate``) on CUDA tensors and runs the plain version on CPU
tensors; any other device raises, and so does a launch whose N heads of K
and V do not fit a block's shared memory (f32 ``batched8`` at L = 258,
``batched8`` at hd = 32). Each rung counts its own launches in
``KERNELS[mode]``; none of them adds to ``flash_attention.KERNEL_FWD``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from applecider_tpu_torch.ops import flash_attention as fa
from applecider_tpu_torch.ops.kernel import CudaKernel, dtype_code, require_aligned

MODES = ("full", "no_prng", "prng_only_no_apply", "matmul_only", "batched4", "batched8")
# the KeepMode of csrc/flash_attention.cu each rung launches, and its code
_KEEP_MODE = {"full": "kPhilox", "no_prng": "kKeepAll", "prng_only_no_apply": "kDrawOnly",
              "matmul_only": "kMatmulOnly", "batched4": "kKeepAll", "batched8": "kKeepAll"}
_KEEP_CODE = {"kKeepAll": 0, "kPhilox": 1, "kDrawOnly": 3, "kMatmulOnly": 4}
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_uint32] + [ctypes.c_int] * 3
KERNELS = {mode: CudaKernel("flash_attention", "ac_flash_fwd_ablate", _ARGS) for mode in MODES}


def pair_block(mode: str) -> int:
    """Heads a block for ``mode``: N for ``batched{N}``, else 0 (one)."""
    return int(mode[len("batched"):]) if mode.startswith("batched") else 0


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; the ladder has {MODES}")


def route(mode: str, dtype: torch.dtype) -> str:
    """The kernel of ``csrc/flash_attention.cu`` that rung ``mode`` launches
    for ``dtype``: the tensor-core forward in bf16, the FMA one in f32."""
    _check_mode(mode)
    kernels = {torch.bfloat16: ("flash_fwd_mma_kernel", "flash_fwd_mma_pairs_kernel"),
               torch.float32: ("flash_fwd_kernel", "flash_fwd_pairs_kernel")}
    if dtype not in kernels:
        raise TypeError(f"the ladder's kernels take float32 or bfloat16, got {dtype}")
    one, pairs = kernels[dtype]
    return pairs if pair_block(mode) else f"{one}<{_KEEP_MODE[mode]}>"


def _validate(q, mode: str) -> None:
    """Refuses, on every device, an unknown mode or ``pair_block`` not
    dividing H."""
    _check_mode(mode)
    n = pair_block(mode)
    if n and q.shape[1] % n:
        raise ValueError(f"{mode}: pair_block {n} does not divide H = {q.shape[1]}")


def flash_forward_ablation_reference(q, k, v, key_padding_mask, mode: str, rate: float = 0.4,
                                     seed: int = 0) -> torch.Tensor:
    """Plain version of every rung; ``full`` draws from
    ``flash_attention.dropout_bits_reference``, the kernels' Philox stream."""
    _validate(q, mode)
    thresh, _ = fa._drop_consts(rate)
    if mode == "full":
        return fa.flash_attention_reference(q, k, v, key_padding_mask,
                                            fa._cpu_keep(q, seed, None, thresh), rate)
    if mode == "matmul_only":
        scores = fa._scores(q, k, key_padding_mask)
        return torch.matmul(scores.to(q.dtype).float(), v.float()).to(q.dtype)
    p_un, denom = fa._probs(q, k, key_padding_mask)
    if mode == "prng_only_no_apply":
        B, H, L, _ = q.shape
        bits = fa.dropout_bits_reference(seed, B, H, L, device=q.device)
        p_un = p_un + (bits & 1).float() * 0.0
    pv = torch.matmul(p_un.to(q.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def matmul_only_magnitude(q, k, v, key_padding_mask) -> torch.Tensor:
    """sum_j |p_j| |v_j| of the ``matmul_only`` rung, f32: the scale of the
    rounding error of its f32 sums. Its terms are of order 1e9 and cancel,
    so two summation orders differ by ~1e-7 of this, not of |out|."""
    p = fa._scores(q, k, key_padding_mask).to(q.dtype).float()
    return torch.matmul(p.abs(), v.float().abs())


def flash_forward_ablation(q, k, v, key_padding_mask, mode: str, rate: float = 0.4,
                           seed: int = 0) -> torch.Tensor:
    """One rung of the ladder: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _validate(q, mode)
    if q.device.type == "cpu":
        return flash_forward_ablation_reference(q, k, v, key_padding_mask, mode, rate, seed)
    dev = fa._check(q, k, v, key_padding_mask)
    if q.dtype == torch.bfloat16:  # the tensor-core kernels load 16 bytes at a time
        require_aligned(q, k, v)
    thresh, drop_scale = fa._drop_consts(rate)
    B, H, L, hd = q.shape
    out = torch.empty_like(q)
    KERNELS[mode].launch(dev, q, k, v, key_padding_mask, out, B, H, L, hd, 1.0 / math.sqrt(hd),
                         thresh, drop_scale, int(seed) & 0xFFFFFFFF, dtype_code(q.dtype),
                         _KEEP_CODE[_KEEP_MODE[mode]], pair_block(mode))
    return out
