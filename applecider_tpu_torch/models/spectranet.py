"""SpectraNet and its TriPool variant, the spectra encoders, and their tasks.

Counterpart of ``applecider_tpu/models/spectranet.py``:

* ``SpectraBlock`` and ``SpectraNetModule``: five stages of multi-kernel
  conv banks, each followed by LN+GELU (kernel K3) and, between stages, a
  1x1 downsample and a max pool of 4; an adaptive max pool over length and
  an MLP head. ``embedding=True`` (the fusion model and the serving stream)
  returns the pre-classifier hidden (B, head_hidden); otherwise the head
  ends in ``FastDropout(head_dropout)`` and ``head_fc2``, with
  ``num_classes`` logits, or with ``redshift`` one output (softplus'd when
  ``redshift_softplus``), returned as (B,);
* ``SpectraNetTask`` (registered as ``SpectraNet``): the focal loss, or the
  MSE against the redshifts; AdamW;
* ``SpectraBlockTriPool`` and ``SpectraNetTriPoolModule``: the brew_cider
  variant, a 1x1 conv residual around each conv bank, LayerNorm or frozen
  BatchNorm, the residual added before exact GELU, and a tri-pool
  ``[max, avg, min]`` concatenated on channels between stages; the
  channel-major flatten, then ``head_fc1`` (2048) and ``head_fc2`` (256),
  each with LayerNorm, GELU and dropout (0.5, 0.3), then ``fc`` with
  ``classification``;
* ``SpectraNetTriPoolTask`` (registered as ``SpectraNetTriPool``).

Activations are (B, L, C) at every module boundary, as in the JAX package;
each conv bank runs channels-first inside the block.

Dtypes follow the JAX package's promotion exactly: a conv runs in its
input's dtype and adds its f32 bias after, which lifts a bf16 product to
f32, so the LN+GELU epilogue (and TriPool's norm, residual and GELU) always
sees f32; the block then casts to the compute dtype, the 1x1 downsample
adds its f32 bias again, and in bf16 mode every SpectraNet stage after the
first convolves in f32. TriPool's pools run in the compute dtype. The
heads run in f32.

TriPool's norm and GELU are not K3: a residual is added between them, so
they are plain PyTorch, and no kernel runs on the TriPool path. Its BatchNorm
is frozen, as the JAX package runs it (``use_running_average=True``): the
running statistics are buffers, read in every mode and never updated.
Where the JAX task keeps them on the task object (``batch_stats``), the port
keeps them in the module, so they travel in its ``state_dict`` and the
checkpoint. flax sizes TriPool's ``head_fc1`` from the first batch it
sees; the port from the spectrum's length given at construction
(``length``, 3481 bins by default).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.datasets.spectra_dataset import SpectraDataset
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task, adamw, maybe_softmax
from applecider_tpu_torch.models.layers import (
    LayerNorm, LayerNormGelu, Linear, gelu_exact, init_weights, uniform_,
)
from applecider_tpu_torch.ops.conv1d import avg_pool1d, conv1d_ncl, max_pool1d, min_pool1d
from applecider_tpu_torch.ops.dropout import FastDropout
from applecider_tpu_torch.ops.losses import focal_loss
from applecider_tpu_torch.registry import register_model

DEFAULT_BANKS = ((3, 61, 1021), (3, 31, 251), (3, 15, 61), (3, 11, 31), (3, 7, 13))
SPECTRUM_BINS = 3481  # the spectrum grid, 4500-7980 A at 1 A
TRIPOOL_CHANNELS = (16, 32, 64, 128, 256)


class Conv1d(nn.Module):
    """Parameters of one 'same' odd-K conv: weight (Cout, Cin, K), f32 bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def reset_parameters(self, generator=None) -> None:
        cout, cin, k = self.weight.shape
        bound = 1.0 / math.sqrt(cin * k)
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def pointwise(self, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 conv on (B, L, Cin): the product in x's dtype, then the
        f32 bias."""
        return F.linear(x, self.weight[:, :, 0].to(x.dtype)) + self.bias


def _bank(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The block's conv bank on x (B, L, Cin), outputs concatenated on
    channels: (B, L, n_convs * Cout)."""
    xc = x.transpose(1, 2)
    convs = [getattr(block, f"conv_{i}") for i in range(block.n_convs)]
    return torch.cat([conv1d_ncl(xc, c.weight, c.bias) for c in convs], dim=1).transpose(1, 2)


class SpectraBlock(nn.Module):
    """Multi-kernel conv bank -> LN+GELU (K3) -> cast (-> 1x1 conv + max pool 4)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_sizes: Sequence[int],
                 do_pool: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.n_convs = len(kernel_sizes)
        self.do_pool = do_pool
        self.dtype = dtype
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"conv_{i}", Conv1d(in_channels, out_channels, k))
        self.norm = LayerNormGelu(out_channels * len(kernel_sizes))
        if do_pool:
            self.downsample = Conv1d(out_channels * len(kernel_sizes), out_channels, 1)
        self.out_channels = out_channels if do_pool else out_channels * len(kernel_sizes)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x (B, L, Cin) -> (B, L or L // 4, C_out)."""
        y = self.norm(_bank(self, x).contiguous(), kernels=kernels)
        if self.dtype is not None:
            y = y.to(self.dtype)
        if self.do_pool:
            y = max_pool1d(self.downsample.pointwise(y), 4)
        return y


class SpectraNetModule(nn.Module):
    """Five-stage SpectraNet: logits (B, num_classes), the redshift (B,), or
    with ``embedding`` the pre-classifier hidden (B, head_hidden); f32."""

    def __init__(self, channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 depths: Sequence[int] = (1, 1, 1, 1, 1),
                 kernel_sizes_per_stage: Sequence[Sequence[int]] = DEFAULT_BANKS,
                 num_classes: int = 9, head_hidden: int = 384, head_dropout: float = 0.5,
                 redshift: bool = False, redshift_softplus: bool = False,
                 embedding: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.embedding = embedding
        self.redshift = redshift
        self.redshift_softplus = redshift_softplus
        self.block_names = []
        cin = 1
        n_stages = len(channels)
        for s in range(n_stages):
            for d in range(int(depths[s])):
                name = f"stage{s}_block{d}"
                block = SpectraBlock(
                    cin, int(channels[s]), tuple(kernel_sizes_per_stage[s]),
                    do_pool=(s != n_stages - 1) and d == int(depths[s]) - 1, dtype=dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                cin = block.out_channels
        self.head_fc1 = Linear(cin, head_hidden)
        self.head_norm = LayerNorm(head_hidden)
        self.embedding_dim = head_hidden
        if not embedding:
            self.head_drop = FastDropout(head_dropout)
            self.head_fc2 = Linear(head_hidden, 1 if redshift else num_classes)

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x (B, L) or (B, L, 1) spectrum."""
        if x.dim() == 2:
            x = x[..., None]
        x = x.to(self.dtype or torch.float32)
        for name in self.block_names:
            x = getattr(self, name)(x, kernels=kernels)
        x = x.amax(dim=1).float()  # adaptive max pool over length
        h = gelu_exact(self.head_norm(self.head_fc1(x)))
        if self.embedding:
            return h
        out = self.head_fc2(self.head_drop(h))
        if self.redshift:
            out = out[..., 0]
            if self.redshift_softplus:
                out = F.softplus(out)
        return out


def spectra_to_tensor(data_dict: dict) -> tuple[np.ndarray, ...]:
    """(flux (B, L), labels, redshifts) from a ``SpectraDataset`` batch; a
    channel-first (B, 1, L) flux loses its channel axis. The redshifts come
    last, so ``Trainer.evaluate`` scores a classifier's predictions against
    them, as the JAX trainer does."""
    data = data_dict["data"]
    flux = np.asarray(data.get("flux", []), dtype=np.float32)
    if flux.ndim == 3:
        flux = flux[:, 0, :]
    labels = np.asarray(data.get("label", []), dtype=np.int64)
    redshifts = np.asarray(data.get("redshift", []), dtype=np.float32)
    return (flux, labels, redshifts)


@register_model(name="SpectraNet")
class SpectraNetTask(Task):
    """The SpectraNet classifier (focal loss, ``focal_gamma``) or, with
    ``model.SpectraNet.redshift``, the redshift regressor (MSE); AdamW at
    ``lr`` with ``weight_decay``; no gradient clip."""

    name = "SpectraNet"

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        mc = cfg["model"]["SpectraNet"]
        self.mc = mc
        self.redshift = bool(mc.get("redshift", False))
        order = mc.get("class_order", 9)  # a list of class names, or a count
        module = SpectraNetModule(
            channels=tuple(mc["channels"]), depths=tuple(mc["depths"]),
            kernel_sizes_per_stage=tuple(tuple(k) for k in mc["kernel_sizes_per_stage"]),
            num_classes=len(order) if isinstance(order, (list, tuple)) else int(order),
            head_hidden=int(mc.get("head_hidden", 384)),
            head_dropout=float(mc.get("head_dropout", 0.5)), redshift=self.redshift,
            redshift_softplus=bool(mc.get("redshift_softplus", False)),
            dtype=self.compute_dtype())
        self.module = init_weights(module, generator).to(resolve_device(device))

    def loss(self, batch, train: bool = True, kernels: bool = True):
        flux, labels, redshifts = batch
        self.module.train(train)
        out = self.module(flux, kernels=kernels)
        if self.redshift:
            loss = torch.mean((out - redshifts.float()) ** 2)
            return loss, {"metrics": {"loss": loss}}
        loss = focal_loss(out, labels, gamma=float(self.mc.get("focal_gamma", 2.0)))
        return loss, {"metrics": {"loss": loss}, "logits": out}

    def predict(self, batch, kernels: bool = True):
        """The redshift (B,), or the logits (probabilities with
        ``use_probabilities``)."""
        self.module.eval()
        out = self.module(batch[0], kernels=kernels)
        if self.redshift:
            return out
        return maybe_softmax(out, bool(self.mc.get("use_probabilities", False)))

    def make_optimizer(self, params):
        return adamw(params, float(self.mc.get("lr", 1e-4)),
                     float(self.mc.get("weight_decay", 1e-2)))

    to_tensor = staticmethod(spectra_to_tensor)


register_model(SpectraNetTask, name="applecider_tpu.models.spectranet.SpectraNetTask")


# --------------------------------------------------------------------------
# brew_cider variant: skip connections + max/avg/min tri-pooling.


class FrozenBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(use_running_average=True, epsilon=1e-5)`` over the
    channels of (B, L, C): ``F.batch_norm`` with ``training=False`` in every
    mode, so ``Trainer``'s ``.train()`` neither switches it to batch
    statistics nor moves ``running_mean`` and ``running_var``, which are
    constants (buffers), not trainable. ``weight`` and ``bias`` train."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(x.transpose(1, 2), self.running_mean, self.running_var, self.weight,
                         self.bias, training=False, eps=self.eps)
        return y.transpose(1, 2)


class SpectraBlockTriPool(nn.Module):
    """Conv bank -> LayerNorm or frozen BatchNorm -> + 1x1-conv residual ->
    GELU -> cast (-> tri-pool: max, avg, min of 4 on channels, x3)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_sizes: Sequence[int],
                 use_ln: bool = True, do_pool: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        k = len(kernel_sizes)
        self.n_convs = k
        self.do_pool = do_pool
        self.dtype = dtype
        self.proj = Conv1d(in_channels, out_channels * k, 1)
        for i, ks in enumerate(kernel_sizes):
            self.add_module(f"conv_{i}", Conv1d(in_channels, out_channels, ks))
        self.norm = LayerNorm(out_channels * k) if use_ln else FrozenBatchNorm(out_channels * k)
        self.out_channels = out_channels * k * (3 if do_pool else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, Cin) -> (B, L or L // 4, C_out)."""
        y = gelu_exact(self.proj.pointwise(x) + self.norm(_bank(self, x)))
        if self.dtype is not None:
            y = y.to(self.dtype)
        if self.do_pool:
            y = torch.cat([max_pool1d(y, 4), avg_pool1d(y, 4), min_pool1d(y, 4)], dim=-1)
        return y


class SpectraNetTriPoolModule(nn.Module):
    """Five TriPool stages -> channel-major flatten -> 2048 -> 256 (->
    ``fc`` with ``classification``); f32 out."""

    def __init__(self, channels: Sequence[int] = TRIPOOL_CHANNELS,
                 depths: Sequence[int] = (1, 1, 1, 1, 1),
                 kernel_sizes_per_stage: Sequence[Sequence[int]] = DEFAULT_BANKS,
                 use_ln_stages: Sequence[bool] = (False, False, False, False, True),
                 num_classes: int = 9, classification: bool = True,
                 length: int = SPECTRUM_BINS, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.block_names = []
        cin = 1
        n_stages = len(channels)
        for s in range(n_stages):
            for d in range(int(depths[s])):
                name = f"stage{s}_block{d}"
                block = SpectraBlockTriPool(
                    cin, int(channels[s]), tuple(kernel_sizes_per_stage[s]),
                    use_ln=bool(use_ln_stages[s]),
                    do_pool=(s != n_stages - 1) and d == int(depths[s]) - 1, dtype=dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                cin = block.out_channels
                length = length // 4 if block.do_pool else length
        self.head_fc1 = Linear(cin * length, 2048)
        self.head_norm1 = LayerNorm(2048)
        self.head_drop1 = FastDropout(0.5)
        self.head_fc2 = Linear(2048, 256)
        self.head_norm2 = LayerNorm(256)
        self.head_drop2 = FastDropout(0.3)
        self.embedding_dim = 256
        self.fc = Linear(256, num_classes) if classification else None

    def forward(self, x: torch.Tensor, kernels: bool = True) -> torch.Tensor:
        """x (B, L) or (B, L, 1) spectrum -> logits (B, num_classes), or the
        (B, 256) embedding. No kernel runs here; ``kernels`` is taken for
        the interface the fusion model gives its spectra encoder."""
        if x.dim() == 2:
            x = x[..., None]
        x = x.to(self.dtype or torch.float32)
        for name in self.block_names:
            x = getattr(self, name)(x)
        z = x.transpose(1, 2).reshape(x.shape[0], -1).float()  # channel-major, as (B, C, L)
        h = self.head_drop1(gelu_exact(self.head_norm1(self.head_fc1(z))))
        h = self.head_drop2(gelu_exact(self.head_norm2(self.head_fc2(h))))
        return h if self.fc is None else self.fc(h)


def build_tripool(cfg: Config, classification: bool, length: int,
                  dtype: torch.dtype | None) -> SpectraNetTriPoolModule:
    """The TriPool module of ``model.SpectraNetTriPool`` (absent keys take
    the JAX package's defaults: widths 16..256, the published banks and
    LayerNorm in every stage)."""
    tc = dict(cfg["model"].get("SpectraNetTriPool", {}))
    channels = tuple(tc.get("channels", TRIPOOL_CHANNELS))
    n_stages = len(channels)
    return SpectraNetTriPoolModule(
        channels=channels, depths=tuple(tc.get("depths", (1,) * n_stages)),
        kernel_sizes_per_stage=tuple(tuple(k) for k in tc.get("kernel_sizes_per_stage",
                                                               DEFAULT_BANKS)),
        use_ln_stages=tuple(tc.get("use_ln_stages", (True,) * n_stages)),
        num_classes=int(tc.get("num_classes", 9)), classification=classification,
        length=length, dtype=dtype)


@register_model(name="SpectraNetTriPool")
class SpectraNetTriPoolTask(Task):
    """The TriPool classifier: focal loss (``focal_gamma``), AdamW at ``lr``
    with ``weight_decay``, the gradients clipped to global norm 1. The
    spectrum's length is the spectra data set's ``n_bins``."""

    name = "SpectraNetTriPool"
    grad_clip = 1.0

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        self.mc = dict(cfg["model"].get("SpectraNetTriPool", {}))
        length = int(cfg.section("data_set", SpectraDataset.SECTION).get("n_bins", SPECTRUM_BINS))
        module = build_tripool(cfg, classification=True, length=length,
                               dtype=self.compute_dtype())
        self.module = init_weights(module, generator).to(resolve_device(device))

    def loss(self, batch, train: bool = True, kernels: bool = True):
        flux, labels = batch[0], batch[1]
        self.module.train(train)
        logits = self.module(flux)
        loss = focal_loss(logits, labels, gamma=float(self.mc.get("focal_gamma", 2.0)))
        return loss, {"metrics": {"loss": loss}, "logits": logits}

    def predict(self, batch, kernels: bool = True):
        self.module.eval()
        return maybe_softmax(self.module(batch[0]), bool(self.mc.get("use_probabilities", False)))

    def make_optimizer(self, params):
        return adamw(params, float(self.mc.get("lr", 1e-4)),
                     float(self.mc.get("weight_decay", 1e-2)))

    to_tensor = staticmethod(spectra_to_tensor)


register_model(SpectraNetTriPoolTask,
               name="applecider_tpu.models.spectranet.SpectraNetTriPoolTask")
