"""Masked-Event Pre-Training (MPT) of the photometry trunk (counterpart of
``applecider_tpu/models/mpt.py``).

30% of each light curve's valid tokens are masked with *band-stratified*
selection (``band_stratified_mask``), channels 2:7 of the masked tokens
(flux, flux error, one-hot band) are zeroed, and three f32 heads on the
trunk's event tokens predict the flux, the band (3-way cross entropy) and
the next token's dt. The three masked means are summed with the weights
``lambda_f``/``lambda_b``/``lambda_dt`` (5/3/5), and the targets are read
from the clean tensor: the JAX package's two deliberate divergences from
the reference implementation (which multiplies the terms and reads the
targets from the zeroed tensor).

The mask's random stream is not part of the contract; its rule is. In train
mode it draws from the device generator the trainer attaches to the module
(``MPTModule.dropout_rng``); in eval mode from a generator seeded 0, as the
JAX evaluation draws from ``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task, adamw
from applecider_tpu_torch.models.baseline_cls import BaselineCLSEncoder, BaselineCLSTask
from applecider_tpu_torch.models.layers import Linear, init_weights
from applecider_tpu_torch.ops.dropout import DropoutRNG
from applecider_tpu_torch.registry import register_model


def _ranks(scores: torch.Tensor) -> torch.Tensor:
    """Each element's rank in its row, ties broken by position."""
    order = torch.argsort(scores, dim=1, stable=True)
    pos = torch.arange(scores.shape[1], device=scores.device).expand_as(order)
    return torch.empty_like(order).scatter_(1, order, pos)


def band_stratified_mask(bands: torch.Tensor, pad_mask: torch.Tensor, mask_p: float,
                         generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, L) bool: the masked tokens of each row.

    ``bands`` (B, L) int band ids, ``pad_mask`` (B, L) bool (True = padding).
    A row with n valid tokens masks k = max(floor(n * mask_p), 3): k // 3 of
    each band, drawn uniformly without replacement and capped by the band's
    count, then k - 3 * (k // 3) more drawn uniformly from the valid tokens
    not yet selected.
    """
    B, L = bands.shape
    dev = bands.device
    valid = ~pad_mask.bool()
    n_valid = valid.sum(dim=1)
    k = torch.clamp((n_valid.float() * mask_p).to(torch.int64), min=3)
    num_each = k // 3
    extras = k - 3 * num_each
    inf = torch.tensor(float("inf"), device=dev)
    u = torch.rand((3, B, L), generator=generator, device=dev)
    selected = torch.zeros((B, L), dtype=torch.bool, device=dev)
    for band in range(3):
        in_pool = valid & (bands == band)
        rank = _ranks(torch.where(in_pool, u[band], inf))
        quota = torch.minimum(in_pool.sum(dim=1), num_each)
        selected |= in_pool & (rank < quota[:, None])
    pool = valid & ~selected
    rank = _ranks(torch.where(pool, torch.rand((B, L), generator=generator, device=dev), inf))
    return selected | (pool & (rank < extras[:, None]))


def apply_event_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero channels 2:7 (logf, logfe, one-hot band) of the masked tokens."""
    channel_is_masked = torch.arange(x.shape[-1], device=x.device) >= 2
    return torch.where(mask[..., None] & channel_is_masked, torch.zeros((), dtype=x.dtype,
                                                                        device=x.device), x)


class MPTModule(nn.Module):
    """The trunk (time embedding with dropout) and three f32 heads over the
    event tokens: flux (B, L), band logits (B, L, 3), next dt (B, L)."""

    def __init__(self, d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.40, dtype: torch.dtype | None = None):
        super().__init__()
        self.trunk = BaselineCLSEncoder(d_model, n_heads, n_layers, dropout, dtype=dtype,
                                        te_dropout=True)
        self.head_flux = Linear(d_model, 1)
        self.head_band = Linear(d_model, 3)
        self.head_dt = Linear(d_model, 1)
        self.dropout_rng: DropoutRNG | None = None  # the mask's generator in train mode

    def forward(self, x, pad_mask, kernels: bool = True):
        h = self.trunk(x, pad_mask, kernels=kernels)[:, 1:].float()
        return self.head_flux(h)[..., 0], self.head_band(h), self.head_dt(h)[..., 0]


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


@register_model(name="MPT")
@register_model(name="MPTModel")
class MPTTask(Task):
    """Pretrains the trunk on ``model.BaselineCLS``'s widths, with AdamW at
    ``pretrain_lr`` and weight decay 0.01."""

    name = "MPT"

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        mc = cfg["model"]["BaselineCLS"]
        self.mc = mc
        self.grad_clip = float(mc.get("grad_clip", 1.0))
        self.mask_p = float(mc.get("mask_p", 0.30))
        self.lambdas = (float(mc.get("lambda_f", 5.0)), float(mc.get("lambda_b", 3.0)),
                        float(mc.get("lambda_dt", 5.0)))
        module = MPTModule(int(mc["d_model"]), int(mc["n_heads"]), int(mc["n_layers"]),
                           float(mc["dropout"]), dtype=self.compute_dtype())
        self.module = init_weights(module, generator).to(resolve_device(device))

    def loss(self, batch, train: bool = True, kernels: bool = True,
             mask: torch.Tensor | None = None):
        """``mask`` (B, L) bool replaces the drawn mask (tests inject one)."""
        data, pad_mask = batch[0], batch[1]
        self.module.train(train)
        bands = torch.argmax(data[..., 4:7], dim=-1)
        if mask is None:
            rng = self.module.dropout_rng
            gen = (rng.device if train and rng is not None
                   else torch.Generator(device=data.device).manual_seed(0))
            mask = band_stratified_mask(bands, pad_mask, self.mask_p, gen)
        f_hat, b_hat, dt_hat = self.module(apply_event_mask(data, mask), pad_mask,
                                           kernels=kernels)
        loss_f = _masked_mean((f_hat - data[..., 2]) ** 2, mask)
        logp = F.log_softmax(b_hat, dim=-1)
        loss_b = _masked_mean(-torch.gather(logp, -1, bands[..., None])[..., 0], mask)
        dt_gt = F.pad(data[:, 1:, 1], (0, 1))  # the next token's dt, 0 after the last
        loss_dt = _masked_mean((dt_hat - dt_gt) ** 2, mask)
        lf, lb, ldt = self.lambdas
        loss = lf * loss_f + lb * loss_b + ldt * loss_dt
        metrics = {"loss": loss, "loss_f": loss_f, "loss_b": loss_b, "loss_dt": loss_dt}
        return loss, {"metrics": metrics}

    def predict(self, batch, kernels: bool = True):
        """(B, L, 5) f32: the flux, the three band logits and the next dt of
        each event token (the JAX task returns the three as a tuple)."""
        self.module.eval()
        f_hat, b_hat, dt_hat = self.module(batch[0], batch[1], kernels=kernels)
        return torch.cat([f_hat[..., None], b_hat, dt_hat[..., None]], dim=-1)

    def make_optimizer(self, params):
        return adamw(params, float(self.mc.get("pretrain_lr", 1e-4)), 0.01)

    to_tensor = staticmethod(BaselineCLSTask.to_tensor)


register_model(MPTTask, name="applecider_tpu.models.mpt.MPTTask")


def warmstart_classifier_params(classifier_sd: Mapping[str, torch.Tensor],
                                mpt_sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A classifier ``state_dict`` whose ``trunk.*`` entries are the
    pretrained trunk's (copies) and whose other entries are
    ``classifier_sd``'s: the reference's weight surgery
    (baselineCLS_example.py:31-39)."""
    out = dict(classifier_sd)
    for name, value in mpt_sd.items():
        if name.startswith("trunk."):
            out[name] = value.detach().clone()
    return out
