"""BaselineCLS photometry transformer and its classifier task.

Counterpart of ``applecider_tpu/models/baseline_cls.py``: Linear(7 -> d) +
Time2Vec of the dt channel, a zero-init CLS token prepended (never
padded), the post-LN encoder, LayerNorm of the CLS token; with
``classification`` a Linear head to ``num_classes``; returned in f32.
``dropout`` (0.40 at the published widths) is threaded through every
encoder layer; the time embedding takes it only with ``te_dropout`` (the
MPT pretrainer's trunk). ``remat`` is the encoder's
(``layers.TransformerEncoder``); the tasks read it from
``model.BaselineCLS.remat`` through ``resolve_remat``, as the JAX tasks do.

``BaselineCLSTask`` (registered as ``BaselineCLS`` and ``HyraxBaselineCLS``)
trains the classifier with focal loss (``focal_gamma``) and
``optax.adam(lr)``: the JAX task ignores ``weight_decay``, and so does this
one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task, adam, maybe_softmax
from applecider_tpu_torch.models.layers import (
    LayerNorm, Linear, TransformerEncoder, init_weights, resolve_remat,
)
from applecider_tpu_torch.models.time2vec import Time2Vec
from applecider_tpu_torch.ops.dropout import FastDropout
from applecider_tpu_torch.ops.losses import focal_loss
from applecider_tpu_torch.registry import register_model

N_EVENT_FEATURES = 7


class BaselineCLSEncoder(nn.Module):
    """Projection + Time2Vec + CLS + transformer; returns all L+1 tokens."""

    def __init__(self, d_model: int, n_heads: int, n_layers: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, te_dropout: bool = False, remat=False):
        super().__init__()
        self.d_model = d_model
        self.in_proj = Linear(N_EVENT_FEATURES, d_model, dtype=dtype)
        self.time2vec = Time2Vec(d_model, dtype=dtype)
        self.te_drop = FastDropout(dropout) if te_dropout else None
        self.cls_tok = nn.Parameter(torch.empty(1, 1, d_model))
        self.encoder = TransformerEncoder(n_layers, d_model, n_heads, 4 * d_model, dropout,
                                          dtype=dtype, remat=remat)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.cls_tok.zero_()

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor, kernels: bool = True):
        B = x.shape[0]
        te = self.time2vec(x[..., 0])
        if self.te_drop is not None:
            te = self.te_drop(te)
        h = self.in_proj(x) + te
        tok = self.cls_tok.to(h.dtype).expand(B, 1, self.d_model)
        h = torch.cat([tok, h], dim=1)
        pad = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=x.device),
                         pad_mask.bool()], dim=1)
        return self.encoder(h, pad, kernels=kernels)


class BaselineCLSModule(nn.Module):
    """The normalised CLS embedding, (B, d_model) f32, or with
    ``classification`` the classifier's logits, (B, num_classes) f32."""

    def __init__(self, d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 dropout: float = 0.40, dtype: torch.dtype | None = None,
                 classification: bool = False, num_classes: int = 5, remat=False):
        super().__init__()
        self.trunk = BaselineCLSEncoder(d_model, n_heads, n_layers, dropout, dtype=dtype,
                                        remat=remat)
        self.norm = LayerNorm(d_model, dtype=dtype)
        self.fc = Linear(d_model, num_classes, dtype=dtype) if classification else None

    def forward(self, x, pad_mask, kernels: bool = True):
        z = self.trunk(x, pad_mask, kernels=kernels)
        out = self.norm(z[:, 0])
        if self.fc is not None:
            out = self.fc(out)
        return out.float()


@register_model(name="BaselineCLS")
@register_model(name="HyraxBaselineCLS")
class BaselineCLSTask(Task):
    name = "BaselineCLS"

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        mc = cfg["model"]["BaselineCLS"]
        self.mc = mc
        self.grad_clip = float(mc.get("grad_clip", 1.0))
        module = BaselineCLSModule(
            int(mc["d_model"]), int(mc["n_heads"]), int(mc["n_layers"]), float(mc["dropout"]),
            dtype=self.compute_dtype(), classification=mc.get("mode", "photo") == "photo",
            num_classes=int(mc["num_classes"]), remat=resolve_remat(mc.get("remat", "auto")))
        self.module = init_weights(module, generator).to(resolve_device(device))

    def loss(self, batch, train: bool = True, kernels: bool = True):
        data, pad_mask, labels = batch
        self.module.train(train)
        logits = self.module(data, pad_mask, kernels=kernels)
        loss = focal_loss(logits, labels, gamma=float(self.mc.get("focal_gamma", 2.0)))
        # the reference logs the per-batch TDE count (HyraxBaselineCLS.py:120)
        metrics = {"loss": loss, "num_tdes": torch.sum(labels == 4)}
        return loss, {"metrics": metrics, "logits": logits}

    def predict(self, batch, kernels: bool = True):
        self.module.eval()
        logits = self.module(batch[0], batch[1], kernels=kernels)
        return maybe_softmax(logits, bool(self.mc.get("use_probabilities", False)))

    def make_optimizer(self, params):
        return adam(params, float(self.mc.get("lr", 1e-4)))

    @staticmethod
    def to_tensor(data_dict: dict) -> tuple[np.ndarray, ...]:
        """(photometry, pad_mask, labels): the four continuous channels
        normalised by the batch's train stats, ``(x - mean) / (std + 1e-8)``."""
        data = data_dict["data"]
        photo = np.asarray(data["photometry"], dtype=np.float32).copy()
        labels = np.asarray(data.get("label", []), dtype=np.int64)
        mean = np.asarray(data["mean"], dtype=np.float32)
        std = np.asarray(data["std"], dtype=np.float32)
        photo[..., :4] = (photo[..., :4] - mean) / (std + 1e-8)
        if "pad_mask" in data:
            pad_mask = np.asarray(data["pad_mask"], dtype=bool)
        else:
            pad_mask = np.zeros(photo.shape[:2], dtype=bool)
        return (photo, pad_mask, labels)


register_model(BaselineCLSTask, name="applecider_tpu.models.baseline_cls.BaselineCLSTask")
