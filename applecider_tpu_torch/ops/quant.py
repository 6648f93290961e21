"""Post-training int8 quantization for the serving path (opt-in).

Counterpart of ``applecider_tpu/ops/quant.py``: static PTQ with

* **weights**: symmetric per-output-channel int8, ``s_w = max(max|w| over
  the non-output axes / 127, 1e-12)`` and ``qw = round(w / s_w)``;
* **activations**: symmetric per-tensor scales, the absmax of each layer's
  input seen during an eager calibration pass (``calibrate``).

The hook sits in the port's layer primitives (``models/layers.Linear``,
``models/convnext.Conv2dTorch``, ``models/spectranet``'s ``Conv1d`` bank
convs and 1x1 convs) and is active only inside ``quantized(scales)`` or
``observing(out)``, context managers on thread-local state. A layer's key
is the JAX package's ``"/".join(module.path)``: the port's modules carry
the flax names, so ``set_paths(model)`` gives each submodule its dotted
name with ``/`` as ``quant_path`` (a module never given one is a root,
key ``""``). ``quant_dense``/``quant_conv`` return None where the float
path runs: no context, observing, or a missing or bad scale.

The arithmetic is the JAX package's, in its order, so that it holds bit
for bit: ``q = int8(clip(rint(x_f32 * float32(127 / s_in)), -127, 127))``
(``ops.int8.quantize``), the exact int32 product (``ops.int8.gemm`` and
``conv2d``), then ``float32(acc) * (float32(s_in / 127) * s_w) (+ bias)``
and the cast to the layer's ``dtype or x.dtype`` (``x.dtype`` for the 1-D
convs, whose JAX module has no dtype). On CUDA tensors the int8 kernels of
``csrc/int8.cu`` run, on CPU tensors their twins; ``quantized(...,
kernels=False)`` takes the twins on any device (the yardstick).

Kept divergence of mechanism: a serving pipeline built with scales
quantizes its layers once (``prepare``: the int8 weights, the epilogue
scales and the f32 biases, keyed by ``quant_path``) and hands them to
``quantized(..., layers=)``, where the JAX package requantizes them in its
graph and XLA folds that for frozen params; the values are the same.
Without ``layers`` a hook quantizes its layer's weights on each call.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.ops import int8

_state = threading.local()


def _ctx():
    if not hasattr(_state, "mode"):
        _state.mode = "off"
        _state.scales = None
        _state.observed = None
        _state.kernels = True
        _state.layers = None
    return _state


class quantized:
    """Context manager: quantizable layers compute in int8 using ``scales``.

    ``scales`` maps module paths (``quant_path``) to per-tensor input
    scales (positive floats from ``calibrate``). Layers whose path is
    missing take the normal float path. ``kernels=False`` runs the int8
    kernels' plain twins on any device. ``layers`` (from ``prepare(model,
    scales)``) holds the layers already quantized; with it the hooks look
    their weights up instead of quantizing them.
    """

    def __init__(self, scales: dict, kernels: bool = True, layers: Optional[dict] = None):
        self.scales = dict(scales)
        self.kernels = bool(kernels)
        self.layers = layers

    def __enter__(self):
        st = _ctx()
        self._prev = (st.mode, st.scales, st.kernels, st.layers)
        st.mode, st.scales, st.kernels, st.layers = "int8", self.scales, self.kernels, self.layers
        return self

    def __exit__(self, *exc):
        st = _ctx()
        st.mode, st.scales, st.kernels, st.layers = self._prev
        return False


class observing:
    """Context manager: record each quantizable layer's input absmax into
    ``out`` (a dict, path -> the largest finite absmax seen)."""

    def __init__(self, out: dict):
        self.out = out

    def __enter__(self):
        st = _ctx()
        self._prev = (st.mode, st.observed)
        st.mode, st.observed = "observe", self.out
        return self

    def __exit__(self, *exc):
        st = _ctx()
        st.mode, st.observed = self._prev
        return False


def set_paths(model: nn.Module) -> nn.Module:
    """Give every submodule of ``model`` its key: its name in
    ``named_modules()`` with ``/`` for ``.``, the flax module path."""
    for name, m in model.named_modules():
        m.quant_path = name.replace(".", "/")
    return model


def _observe(path: str, x: torch.Tensor) -> None:
    st = _ctx()
    m = float(x.detach().float().abs().max())
    if np.isfinite(m) and m > st.observed.get(path, 0.0):
        st.observed[path] = m


class QuantLayer(NamedTuple):
    """A layer ready for the int8 path: its input scale, its int8 weight,
    the epilogue's f32 scale ``float32(s_in / 127) * s_w`` (out,) and its
    f32 bias (or None)."""
    s_in: float
    qw: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]


def _usable(s_in) -> Optional[float]:
    return None if s_in is None or not np.isfinite(s_in) or s_in <= 0.0 else float(s_in)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight (axis 0 is the output) and
    its f32 scale (out,): ``s_w = max(max|w| / 127, 1e-12)``,
    ``round(w / s_w)``, a division as the JAX package computes it."""
    w32 = weight.detach().float()
    dims = tuple(range(1, w32.dim()))
    s_w = torch.clamp_min(w32.abs().amax(dim=dims, keepdim=True) / 127.0, 1e-12)
    return torch.round(w32 / s_w).to(torch.int8), s_w.reshape(-1)


def _quant_layer(module: nn.Module, s_in: float) -> QuantLayer:
    qw, s_w = quantize_weight(module.weight)
    b = getattr(module, "bias", None)
    # float32(s_in / 127) is exact in f32 and goes to the device as a kernel
    # argument, not a copy
    return QuantLayer(s_in, qw, s_w * float(np.float32(s_in / 127.0)),
                      None if b is None else b.detach().float().contiguous())


def prepare(model: nn.Module, scales: dict) -> dict:
    """{path: QuantLayer} for each layer of ``model`` (paths from
    ``set_paths``) with a usable scale in ``scales``: its weights quantized
    once, for ``quantized(scales, layers=...)``."""
    layers = {}
    for name, m in model.named_modules():
        path = getattr(m, "quant_path", name.replace(".", "/"))
        s_in = _usable(scales.get(path))
        w = getattr(m, "weight", None)
        if s_in is not None and isinstance(w, torch.Tensor) and w.dim() >= 2:
            layers[path] = _quant_layer(m, s_in)
    return layers


def _active_layer(module: nn.Module, x: torch.Tensor) -> Optional[QuantLayer]:
    """The layer ready for int8 when it computes in int8, else None (after
    recording its input when observing)."""
    st = _ctx()
    if st.mode == "off":
        return None
    path = getattr(module, "quant_path", "")
    if st.mode == "observe":
        _observe(path, x)
        return None
    if st.layers is not None:
        return st.layers.get(path)
    s_in = _usable(st.scales.get(path))
    return None if s_in is None else _quant_layer(module, s_in)


def quantize_input(x: torch.Tensor, s_in: float, kernels: bool = True) -> torch.Tensor:
    """int8 ``rint(x_f32 * float32(127 / s_in))`` clamped to +-127."""
    inv = float(np.float32(127.0 / s_in))
    return (int8.quantize if kernels else int8.quantize_reference)(x, inv)


def quant_dense(x: torch.Tensor, module: nn.Module) -> Optional[torch.Tensor]:
    """int8 path of a Linear (weight (out, in)) on x (..., in); None ->
    the caller's float path. Out dtype: ``module.dtype or x.dtype``."""
    layer = _active_layer(module, x)
    if layer is None:
        return None
    kernels = _ctx().kernels
    qx = quantize_input(x, layer.s_in, kernels).reshape(-1, x.shape[-1])
    y = (int8.gemm if kernels else int8.gemm_reference)(
        qx, layer.qw, layer.scale, layer.bias, module.dtype or x.dtype)
    return y.reshape(*x.shape[:-1], layer.qw.shape[0])


def quant_conv(x: torch.Tensor, module: nn.Module, out_dtype: torch.dtype, stride=1, padding=0,
               groups: int = 1) -> Optional[torch.Tensor]:
    """int8 path of a convolution on channels-last x: (B, H, W, Cin) with a
    (Cout, Cin / groups, kh, kw) weight, or (B, L, Cin) with a (Cout, Cin,
    K) weight (a 1 x L image); ``stride`` and ``padding`` as the float
    conv takes them. None -> the caller's float path."""
    layer = _active_layer(module, x)
    if layer is None:
        return None
    kernels = _ctx().kernels
    qx, qw = quantize_input(x, layer.s_in, kernels), layer.qw
    one_d = x.dim() == 3
    if one_d:
        qx, qw = qx[:, None], qw[:, :, None]
        stride, padding = (1, stride), (0, padding)
    else:
        stride, padding = (stride, stride), (padding, padding)
    y = (int8.conv2d if kernels else int8.conv2d_reference)(
        qx, qw, layer.scale, layer.bias, out_dtype, stride, padding, groups)
    return y[:, 0] if one_d else y


def calibrate(apply_fn: Callable, batches: list, percentile_headroom: float = 1.0) -> dict:
    """Run ``apply_fn(batch)`` eagerly per batch; return {path: scale}, the
    running absmax of each layer's input times ``percentile_headroom``
    (keep 1.0 for plain absmax)."""
    observed: dict = {}
    with observing(observed):
        for b in batches:
            apply_fn(b)
    return {k: float(v) * percentile_headroom for k, v in observed.items()}


def quant_error_report(probs_f32: np.ndarray, probs_int8: np.ndarray) -> dict:
    """Agreement stats between the float and int8 serving outputs."""
    p32 = np.asarray(probs_f32, np.float64)
    p8 = np.asarray(probs_int8, np.float64)
    top1_match = float(np.mean(p32.argmax(1) == p8.argmax(1)))
    max_abs = float(np.max(np.abs(p32 - p8)))
    mean_abs = float(np.mean(np.abs(p32 - p8)))
    return {"top1_agreement": top1_match, "max_abs_prob_diff": max_abs,
            "mean_abs_prob_diff": mean_abs}
