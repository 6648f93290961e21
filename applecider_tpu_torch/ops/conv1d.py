"""1-D convolution and pooling for SpectraNet and its TriPool variant.

Counterpart of ``applecider_tpu/ops/conv1d.py``: the 'same' odd-K
cross-correlation by three routes, and the three pools (``max_pool1d``,
``avg_pool1d``, ``min_pool1d``).

* ``conv1d_direct``: cuDNN's convolution through ``F.conv1d``, in x's dtype.
  In bf16 its input gradient is computed in f32 from the bf16 operands and
  rounded to bf16 (``_DirectBf16``): cuDNN's bf16 data-gradient kernels
  take ~12x the f32 step at TriPool's long banks.
* ``conv1d_fft``: the convolution theorem, ``torch.fft`` in f32 at a
  5-smooth length; the output is f32 whatever x's dtype, as in JAX.
* ``conv1d_s2d``: the space-to-depth (polyphase) rewrite at ``block`` 32, a
  VALID ``F.conv1d`` over R-fold channels; the output is in x's dtype.
* ``conv1d(x, weight, bias, mode, fft_len)``: the dispatch of the JAX
  package, with its modes ("auto", "direct", "s2d", "fft"), its cost model
  (``_fft_wins``, ``_s2d_wins``) and its environment overrides
  (``ACFFT_PENALTY``, ``ACS2D``). The platform's constants are chosen by the
  tensor's device: the CPU takes JAX's CPU constants, CUDA the constants
  measured on the H100 (``chip_smoke.py`` phase 14,
  ``tools/conv_routes.py``); any other device raises.

The JAX package computes the FFT and space-to-depth routes in XLA, outside
any Pallas kernel, so here they are PyTorch's ``torch.fft`` and cuDNN.
Public layouts follow the JAX package: activations are (B, L, C); weights
are the port's (Cout, Cin, K).
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("auto", "direct", "s2d", "fft")

# a kernel narrower than this never takes the FFT route
FFT_KERNEL_THRESHOLD = 16
_FFT_ACT_C = 3.0   # per-point n*log2(n) cost of an activation rfft/irfft
_FFT_KER_C = 32.0  # the same for the kernel's rfft (cin*cout transforms), which
#                    runs at every call: per sample it divides by the batch

# How much slower one FFT-route FLOP is than one direct FLOP, by device type
# (``ACFFT_PENALTY`` overrides both). cpu: the JAX package's CPU constant.
# cuda: measured on an H100 80GB HBM3 at 700 W (``tools/conv_routes.py``,
# PERF.md section 6): every penalty in (11.3, 17.2) routes SpectraNet's and
# TriPool's bank shapes at serving and training batches with the least time
# lost to misroutes (FFT for K = 1021, 251 and, from ~90 rows, stage 2's 61);
# 12 keeps stage 2's K = 61 on the FFT route at 128 rows as at 256.
_PENALTY = {"cpu": 6.0, "cuda": 12.0}
# Whether ``auto`` takes space-to-depth for a long kernel over one or two
# channels (K >= 512, cin <= 2) without ``ACS2D``: never on the CPU (as JAX's
# CPU router), and on CUDA as measured by the same table.
_S2D_AUTO = {"cpu": False, "cuda": False}


def platform_of(device: torch.device) -> str:
    if device.type not in _PENALTY:
        raise ValueError(f"conv1d routes tensors on the CPU or CUDA, not on {device}")
    return device.type


def _fft_cost_penalty(platform: str) -> float:
    env = os.environ.get("ACFFT_PENALTY")
    return float(env) if env is not None else _PENALTY[platform]


# the batch a symbolic batch (``torch.export``) is routed at; None: its example
_ROUTE_BATCH: int | None = None


@contextlib.contextmanager
def route_batch(n: int):
    """Route the convolutions of a program exported with a symbolic batch
    as at ``n`` rows (the batch it will serve): the route is part of the
    exported program, and deciding it on the symbolic size would guard it."""
    global _ROUTE_BATCH
    saved, _ROUTE_BATCH = _ROUTE_BATCH, int(n)
    try:
        yield
    finally:
        _ROUTE_BATCH = saved


def _concrete(n) -> int:
    """A size as an int; a symbolic batch at ``route_batch``'s size, else at
    its example value."""
    if isinstance(n, torch.SymInt):
        if _ROUTE_BATCH is not None:
            return _ROUTE_BATCH
        from torch.fx.experimental.symbolic_shapes import hint_int

        return int(hint_int(n))
    return int(n)


def _fft_wins(L: int, K: int, cin: int, cout: int, batch: int = 64,
              platform: str = "cpu") -> bool:
    """The cost model's route for ``auto``: FFT when its per-sample cost,
    scaled by the platform's penalty, is below the direct convolution's.

    direct: 2*L*K*cin*cout FLOPs; fft: the complex product (8 FLOPs per
    (f, cin, cout)), the rfft/irfft of the activations ((cin + cout)
    transforms) and the kernel's rfft (cin*cout transforms over the batch).
    JAX's frozen-kernel hint has no counterpart: the kernel term is always on.
    """
    if K < FFT_KERNEL_THRESHOLD:
        return False
    direct, fft = fft_costs(L, K, cin, cout, batch)
    return fft * _fft_cost_penalty(platform) < direct


def fft_costs(L: int, K: int, cin: int, cout: int, batch: int = 64) -> tuple[float, float]:
    """(direct, FFT) per-sample costs of the cost model, the FFT's before
    the platform's penalty."""
    n = _next_fast_len(L + K - 1)
    nlg = n * math.log2(n)
    kernel_term = _FFT_KER_C * nlg * cin * cout / max(_concrete(batch), 1)
    fft = 8.0 * (n // 2 + 1) * cin * cout + _FFT_ACT_C * nlg * (cin + cout) + kernel_term
    return 2.0 * L * K * cin * cout, fft


def _s2d_wins(K: int, cin: int, platform: str = "cpu") -> bool:
    """``auto``'s space-to-depth route for a long kernel over few channels
    (K >= 512, cin <= 2). ``ACS2D``: "0" disables it, "1" applies the shape
    rule on every platform; unset, the platform's measured choice."""
    env = os.environ.get("ACS2D")
    if env == "0" or K < 512 or cin > 2:
        return False
    return env == "1" or _S2D_AUTO[platform]


def takes_fft_path(B: int, L: int, k: int, cin: int, cout: int, mode: str,
                   platform: str) -> bool:
    """Whether a conv of a bank runs the FFT route (JAX ``_takes_fft_path``)."""
    return mode == "fft" or (mode == "auto" and _fft_wins(L, k, cin, cout, batch=B,
                                                          platform=platform))


def bank_fft_len(B: int, L: int, cin: int, cout: int, kernel_sizes, mode: str,
                 platform: str) -> int | None:
    """The 5-smooth FFT length a bank's FFT-route convs share, so x's rfft is
    computed once for them (JAX ``_bank_fft_len``); None if none takes it."""
    ks = [k for k in kernel_sizes if takes_fft_path(B, L, k, cin, cout, mode, platform)]
    return _next_fast_len(L + max(ks) - 1) if ks else None


def route(B: int, L: int, k: int, cin: int, cout: int, mode: str, platform: str) -> str:
    """The route ``conv1d`` takes: "s2d", "fft" or "direct"."""
    if mode == "s2d" or (mode == "auto" and _s2d_wins(k, cin, platform)):
        return "s2d"
    return "fft" if takes_fft_path(B, L, k, cin, cout, mode, platform) else "direct"


def check_mode(mode: str) -> str:
    """``mode`` if it is one of ``MODES``; otherwise ``ValueError`` (the JAX
    package falls through to the direct route)."""
    if mode not in MODES:
        raise ValueError(f"conv_mode must be one of {MODES}, got {mode!r}")
    return mode


# ------------------------------------------------------------------ direct
# False: a bf16 convolution's input gradient is cuDNN's bf16 one, as autograd
# computes it (for an A/B on the card: ``tools/conv_routes.py``)
BF16_INPUT_GRAD_IN_F32 = True


class _DirectBf16(torch.autograd.Function):
    """cuDNN's bf16 convolution (channels-first, stride 1) whose input
    gradient is the transposed convolution in f32 of the bf16 gradient and
    weight, rounded to bf16; the weight gradient is cuDNN's in bf16, as
    autograd computes it."""

    @staticmethod
    def forward(ctx, x, w, padding: int):
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        return F.conv1d(x, w, padding=padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        p = ctx.padding
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv_transpose1d(gy.float(), w.float(), padding=p).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                gy, x, w, None, [1], [p], [1], False, [0], 1, [False, True, False])[1]
        return dx, dw, None


def _conv_ncl(x: torch.Tensor, w: torch.Tensor, padding: int) -> torch.Tensor:
    """``F.conv1d(x, w, padding=padding)`` in x's dtype; a bf16 convolution
    under autograd takes ``_DirectBf16``'s input gradient."""
    w = w.to(x.dtype)
    if x.dtype == torch.bfloat16 and BF16_INPUT_GRAD_IN_F32 and torch.is_grad_enabled() and (
            x.requires_grad or w.requires_grad):
        return _DirectBf16.apply(x, w, padding)
    return F.conv1d(x, w, padding=padding)


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
    y = _conv_ncl(x, weight, k // 2)
    return y if bias is None else y + bias[:, None]


def conv1d_direct(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """'same' cross-correlation, odd K: x (B, L, Cin) -> (B, L, Cout)."""
    return conv1d_ncl(x.transpose(1, 2), weight, bias).transpose(1, 2)


# --------------------------------------------------------------------- s2d
def conv1d_s2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               block: int = 32) -> torch.Tensor:
    """'same' cross-correlation via space-to-depth: x (B, L, Cin) becomes
    (B, ceil(L/R), R*Cin) (R = ``block``), the weight (D, R*Cin, R*Cout) with
    D ~ K/R + 2 taps, and a VALID convolution over the padded blocks gives
    (B, L, Cout), in x's dtype (then the bias, as ``conv1d_direct``).

    y[R*m + r, o] = sum_{d,p,ci} xr[m+d, p, ci] * w2[d, p*Cin+ci, r*Cout+o],
    where w2 takes w's tap R*d + p - r + K//2 (zero outside [0, K)).
    """
    B, L, Cin = x.shape
    C, _, K = weight.shape
    R = block
    P0 = K // 2
    M = -(-L // R)
    d_min = -((P0 + R - 1) // R)
    d_max = (K - 1 + (R - 1) - P0) // R
    D = d_max - d_min + 1
    # the static tap table (D, R, R): tap = R*(d_min+di) + p - r + P0
    tap = (R * (d_min + np.arange(D)[:, None, None]) + np.arange(R)[None, :, None]
           - np.arange(R)[None, None, :] + P0)
    valid = torch.from_numpy((tap >= 0) & (tap < K)).to(weight.device)
    kernel = weight.permute(2, 1, 0)  # (K, Cin, C), JAX's layout
    w_taps = kernel[torch.from_numpy(np.clip(tap, 0, K - 1)).to(weight.device)]  # (D, R, R, Cin, C)
    w2 = torch.where(valid[..., None, None], w_taps, 0)
    w2 = w2.permute(0, 1, 3, 2, 4).reshape(D, R * Cin, R * C)
    xr = F.pad(x, (0, 0, 0, M * R - L)).reshape(B, M, R * Cin)
    xr = F.pad(xr, (0, 0, -d_min, d_max))  # explicit padding, then VALID
    y = _conv_ncl(xr.transpose(1, 2), w2.permute(2, 1, 0), 0)  # (B, R*C, M)
    y = y.transpose(1, 2).reshape(B, M * R, C)[:, :L]
    return y if bias is None else y + bias


# --------------------------------------------------------------------- fft
def _next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) size >= n for efficient FFT."""
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            x = p35
            while x < n:
                x *= 2
            if x < best:
                best = x
            p35 *= 3
        p5 *= 5
    return best


def input_spectrum(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (B, L, Cin)'s rfft along L in f32 at length ``n``: (B, n//2+1, Cin)."""
    return torch.fft.rfft(x.float(), n=n, dim=1)


def conv1d_fft(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
               n: int | None = None, xf: torch.Tensor | None = None) -> torch.Tensor:
    """'same' cross-correlation via rfft, f32 whatever x's dtype: the linear
    convolution with the flipped kernel at length ``n`` (>= L+K-1; by default
    the 5-smooth size), sliced at K//2. ``xf``: x's ``input_spectrum`` at
    ``n``, shared by the FFT-route convs of a bank."""
    B, L, Cin = x.shape
    K = weight.shape[-1]
    if n is None:
        n = _next_fast_len(L + K - 1)
    if n < L + K - 1:
        raise ValueError(f"fft length {n} < L+K-1 = {L + K - 1}")
    if xf is None:
        xf = input_spectrum(x, n)
    wf = torch.fft.rfft(weight.flip(-1).permute(2, 1, 0).float(), n=n, dim=0)  # (F, Cin, Cout)
    y = torch.fft.irfft(torch.einsum("bfi,fio->bfo", xf, wf), n=n, dim=1)
    y = y[:, K // 2:K // 2 + L]
    return y if bias is None else y + bias


# ---------------------------------------------------------------- dispatch
def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           mode: str = "auto", fft_len: int | None = None,
           spectra: dict | None = None) -> torch.Tensor:
    """x (B, L, Cin), weight (Cout, Cin, K) -> (B, L, Cout) by ``mode``:
    "auto" (``_s2d_wins``, then the cost model ``_fft_wins``, else direct),
    "direct", "s2d" or "fft". ``fft_len``: a bank's shared FFT length;
    ``spectra``: a dict, shared by a bank's convs, that keeps x's rfft at each
    length it is computed at."""
    cout, cin, k = weight.shape
    how = route(x.shape[0], x.shape[1], k, cin, cout, check_mode(mode), platform_of(x.device))
    if how == "s2d":
        return conv1d_s2d(x, weight, bias)
    if how == "fft":
        n = fft_len or _next_fast_len(x.shape[1] + k - 1)
        xf = None
        if spectra is not None:
            xf = spectra.get(n)
            if xf is None:
                xf = spectra[n] = input_spectrum(x, n)
        return conv1d_fft(x, weight, bias, n=n, xf=xf)
    return conv1d_direct(x, weight, bias)


# ------------------------------------------------------------------- pools
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
