"""AppleCider four-modality late-fusion model (counterpart of
``applecider_tpu/models/fusion.py``), ``build_fusion_model``, and
``AppleCiderTask``, the model's training task: ``fusion_loss`` (cross
entropy or focal loss, and accuracy), Adam at ``model.AppleCider.lr``,
the clip ``model.AppleCider.grad_clip``, and ``to_tensor``.

The spectra encoder is SpectraNet's embedding (``model.AppleCider.
spectra_encoder = "standard"``, the default) or the TriPool variant's 256
wide embedding (``"tripool"``, widths from ``model.SpectraNetTriPool``, the
variant the paper's fusion model used). Both are per sample, so the
compact spectra block of ``FusedSpectraStream`` stays exact with either.
Each encoder's embedding is projected to ``hidden_dim`` in f32, L2
normalised and fused by average (or concatenation, in the order
photometry, image+metadata, spectra) before the f32 classifier.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.config import Config, compute_dtype, load_defaults
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.astrominn import AstroMiNNModule
from applecider_tpu_torch.models.base import Task, adam, maybe_softmax
from applecider_tpu_torch.models.baseline_cls import BaselineCLSModule
from applecider_tpu_torch.models.layers import Linear, init_weights, resolve_remat
from applecider_tpu_torch.models.spectranet import (
    SPECTRUM_BINS, SpectraNetModule, SpectraNetTriPoolModule, build_tripool,
)
from applecider_tpu_torch.ops.losses import cross_entropy, focal_loss
from applecider_tpu_torch.registry import register_model


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` over the last dim, the norm taken in f32."""
    norm = torch.sqrt(torch.sum(torch.square(x.float()), dim=-1, keepdim=True))
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


class AppleCiderModule(nn.Module):
    def __init__(self, photometry_encoder: BaselineCLSModule,
                 spectra_encoder: SpectraNetModule | SpectraNetTriPoolModule,
                 img_meta_encoder: AstroMiNNModule, photometry_dim: int, spectra_dim: int,
                 img_meta_dim: int, hidden_dim: int = 5, fusion: str = "avg",
                 num_classes: int = 5):
        super().__init__()
        if fusion not in ("avg", "concat"):
            raise NotImplementedError(f"fusion={fusion!r}")
        self.fusion = fusion
        self.num_classes = num_classes
        self.photometry_encoder = photometry_encoder
        self.spectra_encoder = spectra_encoder
        self.img_meta_encoder = img_meta_encoder
        self.photometry_proj = Linear(photometry_dim, hidden_dim)
        self.spectra_proj = Linear(spectra_dim, hidden_dim)
        self.img_metadata_proj = Linear(img_meta_dim, hidden_dim)
        self.fc = Linear(hidden_dim * (3 if fusion == "concat" else 1), num_classes)

    def forward(self, photometry, photo_mask, metadata, images, spectra,
                spec_gather: torch.Tensor | None = None, kernels: bool = True) -> torch.Tensor:
        """photometry (B, L, 7), photo_mask (B, L) bool, metadata (B, 24),
        images (B, 63, 63, 3) NHWC, spectra (B or S+1, G) -> (B, C) f32 logits.

        ``spec_gather`` (B,): ``spectra`` is a compact block whose row 0 is
        the zero spectrum and each batch row takes the embedding of its row
        (the FusedSpectraStream layout). Without it, a one-row ``spectra``
        broadcasts over the batch.
        """
        p = self.photometry_encoder(photometry, photo_mask, kernels=kernels)
        s = self.spectra_encoder(spectra, kernels=kernels)
        im = self.img_meta_encoder(metadata, images)
        return self.fuse(p, s, im, spec_gather)

    def fuse(self, p: torch.Tensor, s: torch.Tensor, im: torch.Tensor,
             spec_gather: torch.Tensor | None = None) -> torch.Tensor:
        """Encoder embeddings -> logits: project, L2-normalise, fuse, classify."""
        p_emb = l2_normalize(self.photometry_proj(p))
        s_emb = l2_normalize(self.spectra_proj(s))
        im_emb = l2_normalize(self.img_metadata_proj(im))
        if spec_gather is not None:
            s_emb = s_emb[spec_gather]
        elif s_emb.shape[0] == 1 and p_emb.shape[0] != 1:
            s_emb = s_emb.expand(p_emb.shape[0], -1)
        if self.fusion == "concat":
            emb = torch.cat([p_emb, im_emb, s_emb], dim=-1)
        else:
            emb = (p_emb + im_emb + s_emb) / 3.0
        return self.fc(emb).float()


def build_fusion_model(cfg: Config | None = None, device="cuda", dtype: torch.dtype | None = None,
                       generator: torch.Generator | None = None) -> AppleCiderModule:
    """The AppleCider model from ``cfg`` (default: the published widths),
    weights drawn from ``generator``, in eval mode on ``device``, its
    parameters frozen for serving; ``train.Trainer`` puts it in train mode
    and unfreezes them.

    ``dtype`` defaults to the config's ``train.compute_dtype``. The model
    runs on CUDA unless ``device="cpu"`` is asked for.
    """
    dev = resolve_device(device)
    cfg = load_defaults() if cfg is None else cfg
    dt = compute_dtype(cfg) if dtype is None else dtype
    pc = cfg["model"]["BaselineCLS"]
    sc = cfg["model"]["SpectraNet"]
    ac = cfg["model"]["AstroMiNN"]
    fc = cfg["model"]["AppleCider"]
    photometry = BaselineCLSModule(int(pc["d_model"]), int(pc["n_heads"]), int(pc["n_layers"]),
                                   float(pc["dropout"]), dtype=dt,
                                   remat=resolve_remat(pc.get("remat", "auto")))
    if str(fc.get("spectra_encoder", "standard")) == "tripool":
        spectra = build_tripool(cfg, classification=False, length=SPECTRUM_BINS, dtype=dt)
    else:
        spectra = SpectraNetModule(
            channels=tuple(sc["channels"]), depths=tuple(sc["depths"]),
            kernel_sizes_per_stage=tuple(tuple(k) for k in sc["kernel_sizes_per_stage"]),
            embedding=True, dtype=dt, conv_mode=str(sc.get("conv_mode", "auto")))
    moe_out = int(ac["moe_output_dims"])
    img_meta = AstroMiNNModule(
        num_experts=int(ac["num_mlp_experts"]), towers_hidden_dims=int(ac["towers_hidden_dims"]),
        towers_outdims=int(ac["towers_outdims"]), fusion_hidden_dims=int(ac["fusion_hidden_dims"]),
        fusion_outdims=int(ac["fusion_outdims"]), moe_output_dims=moe_out,
        backbone_depths=tuple(ac["backbone_depths"]), backbone_dims=tuple(ac["backbone_dims"]),
        dtype=dt)
    model = AppleCiderModule(
        photometry, spectra, img_meta, photometry_dim=int(pc["d_model"]),
        spectra_dim=spectra.embedding_dim,
        img_meta_dim=moe_out, hidden_dim=int(fc["hidden_dim"]), fusion=str(fc["fusion"]),
        num_classes=int(fc["num_classes"]))
    init_weights(model, generator)
    return model.to(dev).eval().requires_grad_(False)


# the names the JAX package registers its AppleCiderTask under
for _name in ("AppleCider", "Fusion", "applecider_tpu.models.fusion.AppleCiderTask"):
    register_model(build_fusion_model, name=_name)


def fusion_loss(logits: torch.Tensor, labels: torch.Tensor, cfg: Config
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy) of ``AppleCiderTask.loss_fn``: focal loss when
    ``model.AppleCider.criterion`` is "focal" (``focal_gamma``), else cross
    entropy."""
    fc = cfg["model"]["AppleCider"]
    if str(fc.get("criterion", "ce")) == "focal":
        loss = focal_loss(logits, labels, gamma=float(fc.get("focal_gamma", 2.0)))
    else:
        loss = cross_entropy(logits, labels)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, acc


def to_tensor(data_dict: dict) -> tuple[np.ndarray, ...]:
    """A collated fusion batch as (photometry, pad_mask, metadata, images,
    spectra, labels) NumPy arrays, as ``AppleCiderTask.to_tensor`` makes
    them: the four continuous photometry channels normalised by the batch's
    ``mean``/``std``, the pad mask (True = padded), images NHWC."""
    data = data_dict["data"]
    photo = np.asarray(data["photometry"], dtype=np.float32).copy()
    if "mean" in data:
        mean = np.asarray(data["mean"], dtype=np.float32)
        std = np.asarray(data["std"], dtype=np.float32)
        photo[..., :4] = (photo[..., :4] - mean) / (std + 1e-8)
    pad_mask = np.asarray(data.get("pad_mask", np.zeros(photo.shape[:2], bool)), dtype=bool)
    metadata = np.asarray(data["metadata"], dtype=np.float32)
    images = np.asarray(data["image"], dtype=np.float32)
    if images.ndim == 4 and images.shape[1] in (1, 3, 4) and images.shape[-1] not in (1, 3, 4):
        images = np.transpose(images, (0, 2, 3, 1))
    spectra = np.asarray(data["spectrum"], dtype=np.float32)
    labels = np.asarray(data.get("label", []), dtype=np.int64)
    return (photo, pad_mask, metadata, images, spectra, labels)


class AppleCiderTask(Task):
    """The fusion model ``module`` (from ``build_fusion_model``) as a
    ``Task``; batches are ``to_tensor``'s six arrays."""

    name = "AppleCider"

    def __init__(self, cfg: Config, module: AppleCiderModule):
        super().__init__(cfg)
        self.fc_cfg = cfg["model"]["AppleCider"]
        self.grad_clip = float(self.fc_cfg.get("grad_clip", 1.0))
        self.module = module

    def loss(self, batch, train: bool = True, kernels: bool = True):
        photometry, photo_mask, metadata, images, spectra, labels = batch
        self.module.train(train)
        logits = self.module(photometry, photo_mask, metadata, images, spectra, kernels=kernels)
        loss, acc = fusion_loss(logits, labels, self.cfg)
        return loss, {"metrics": {"loss": loss, "accuracy": acc}, "logits": logits}

    def predict(self, batch, kernels: bool = True):
        self.module.eval()
        logits = self.module(*batch[:5], kernels=kernels)
        return maybe_softmax(logits, bool(self.fc_cfg.get("use_probabilities", False)))

    def make_optimizer(self, params):
        return adam(params, float(self.fc_cfg.get("lr", 1e-4)))

    to_tensor = staticmethod(to_tensor)
