"""Plain reference of the ``spectranet`` configuration: the SpectraNet
classifier of spectra alone, trained with the focal loss and AdamW."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import layers as L
from benchmark.reference.applecider_fusion import spectra_flops


def classes(cfg: dict) -> int:
    order = cfg["model"]["SpectraNet"].get("class_order", 9)
    return len(order) if isinstance(order, list) else int(order)


def build(cfg: dict) -> L.SpectraNet:
    s = cfg["model"]["SpectraNet"]
    return L.SpectraNet(s["channels"], s["depths"], s["kernel_sizes_per_stage"],
                        s.get("head_hidden", 384), classes(cfg), s.get("head_dropout", 0.5))


def train_batch(samples: list[dict], max_len: int, device) -> tuple:
    flux = torch.as_tensor(np.stack([s["flux"] for s in samples]).astype(np.float32),
                           device=device)
    labels = torch.as_tensor(np.asarray([s["label"] for s in samples], np.int64), device=device)
    return flux, labels


def loss(model: L.SpectraNet, batch: tuple, gamma: float = 2.0) -> torch.Tensor:
    """Focal loss: -(1 - p_y)^gamma log p_y, averaged over the batch."""
    logp = F.log_softmax(model(batch[0]), dim=-1).gather(1, batch[1][:, None])[:, 0]
    return (-(1.0 - logp.exp()) ** gamma * logp).mean()


def optimizer(cfg: dict) -> dict:
    s = cfg["model"]["SpectraNet"]
    return {"lr": s["lr"], "weight_decay": s["weight_decay"], "grad_clip": None}


def forward_flops(cfg: dict, points: int, has_spectrum: bool) -> float:
    return spectra_flops(cfg, classes(cfg))
