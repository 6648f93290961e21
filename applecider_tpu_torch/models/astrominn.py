"""AstroMiNN image + metadata mixture of experts (counterpart of
``applecider_tpu/models/astrominn.py``): eight gated-residual metadata
towers over fixed column slices, a ConvNeXt image tower with a tanh-gated
head, a sigmoid router and a top-2 dense dispatch over the experts.

Dropout sites, live in ``train()`` mode, at the rates the flax modules
hard-code: 0.25 on each tower block's gate and main branches, 0.4 in the
image head, 0.3 on the router.

``AstroMiNNTask`` (registered as ``AstroMiNN``) trains the module alone:
cross entropy on one-hot coarse targets, the accuracy, and AdamW over the
reference's 11 parameter groups (``GROUP_SETTINGS``). No kernel runs on
this path: the JAX package's ConvNeXt, towers and experts are XLA."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task, adamw, maybe_softmax
from applecider_tpu_torch.models.convnext import ConvNeXt
from applecider_tpu_torch.models.layers import LayerNorm, Linear, gelu_exact, init_weights
from applecider_tpu_torch.ops.dropout import FastDropout
from applecider_tpu_torch.ops.losses import cross_entropy
from applecider_tpu_torch.ops.moe import topk_dense_dispatch
from applecider_tpu_torch.registry import register_model

# metadata column slices (the JAX package's TOWER_SLICES)
TOWER_SLICES = {
    "nst1_tower": [0, 2],
    "nst2_tower": [1, 3],
    "spatial_tower": [2, 3, 4],
    "psf_tower": [5, 14],
    "mag_tower": [6, 9, 10, 13, 15, 17, 18],
    "coord_tower": [7, 8],
    "mega_tower": list(range(19)),
    "lc_tower": [6, 9, 10, 13, 15, 17, 18, 19, 20, 21, 22, 23],
}


class ResidualTowerBlock(nn.Module):
    """out = main(h) * sigmoid(gate(h)) + skip(x), h = GELU(start(x)); each
    branch drops ``dropout`` after its LayerNorm."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int, dropout: float = 0.25,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.start = Linear(in_dim, hidden_dim, dtype=dtype)
        self.gate_norm = LayerNorm(hidden_dim, dtype=dtype)
        self.gate_drop = FastDropout(dropout)
        self.gate_fc = Linear(hidden_dim, output_dim, dtype=dtype)
        self.main_norm = LayerNorm(hidden_dim, dtype=dtype)
        self.main_drop = FastDropout(dropout)
        self.main_fc = Linear(hidden_dim, output_dim, dtype=dtype)
        self.skip = Linear(in_dim, output_dim, dtype=dtype) if in_dim != output_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu_exact(self.start(x))
        g = torch.sigmoid(self.gate_fc(self.gate_drop(self.gate_norm(h))))
        m = self.main_fc(self.main_drop(self.main_norm(h)))
        return m * g + (x if self.skip is None else self.skip(x))


class SplitHeadImageTower(nn.Module):
    """ConvNeXt features -> main MLP head, modulated by a tanh aux head."""

    def __init__(self, outdims: int, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 dtype: torch.dtype | None = None):
        super().__init__()
        f = int(dims[-1])
        self.backbone = ConvNeXt(depths, dims, dtype=dtype)
        self.main_norm = LayerNorm(f, dtype=dtype)
        self.main_fc1 = Linear(f, f // 2, dtype=dtype)
        self.main_drop = FastDropout(0.4)
        self.main_fc2 = Linear(f // 2, f, dtype=dtype)
        self.main_fc3 = Linear(f, outdims, dtype=dtype)
        self.aux_norm = LayerNorm(f, dtype=dtype)
        self.aux_fc = Linear(f, outdims, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x)
        m = self.main_drop(torch.relu(self.main_fc1(self.main_norm(gelu_exact(feats)))))
        m = self.main_fc3(self.main_fc2(m))
        a = torch.tanh(self.aux_fc(self.aux_norm(feats)))
        return m * a


class AstroMiNNModule(nn.Module):
    def __init__(self, num_experts: int = 4, towers_hidden_dims: int = 16,
                 towers_outdims: int = 32, fusion_hidden_dims: int = 128,
                 fusion_outdims: int = 32, moe_output_dims: int = 5,
                 backbone_depths=(3, 3, 9, 3), backbone_dims=(96, 192, 384, 768),
                 router_dropout: float = 0.3, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.num_experts = num_experts
        th, to, fo = towers_hidden_dims, towers_outdims, fusion_outdims
        towers = {  # name -> (hidden, out)
            "nst1_tower": (th, fo), "nst2_tower": (th, fo), "spatial_tower": (th, to),
            "psf_tower": (th, to), "mag_tower": (2 * th, to), "coord_tower": (th, fo),
            "mega_tower": (128, to), "lc_tower": (3 * th, to),
        }
        for name, (hid, out) in towers.items():
            self.add_module(name, ResidualTowerBlock(len(TOWER_SLICES[name]), hid, out, dtype=dtype))
            # column indices live on the model's device: indexing with a
            # Python list would copy it to the card and wait for the queue
            self.register_buffer(f"{name}_cols", torch.tensor(TOWER_SLICES[name]), persistent=False)
        self.image_tower = SplitHeadImageTower(to, backbone_depths, backbone_dims, dtype=dtype)
        fusion_dims = 6 * to + 3 * fo
        self.router_fc1 = Linear(fusion_dims, fusion_dims // 2, dtype=dtype)
        self.router_drop = FastDropout(router_dropout)
        self.router_fc2 = Linear(fusion_dims // 2, num_experts, dtype=dtype)
        for i in range(num_experts):
            self.add_module(f"expert_{i}", ResidualTowerBlock(
                fusion_dims, fusion_hidden_dims, moe_output_dims, dtype=dtype))

    def forward(self, metadata: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """metadata (B, 24); image (B, H, W, 3) NHWC -> (B, moe_output_dims) f32."""
        m = metadata.to(self.dtype or torch.float32)

        def tower(name):
            return getattr(self, name)(m.index_select(1, getattr(self, f"{name}_cols")))

        img = self.image_tower(image.to(self.dtype or torch.float32))
        all_feats = torch.cat([
            tower("nst1_tower"), tower("nst2_tower"), tower("spatial_tower"),
            tower("psf_tower"), tower("mag_tower"), tower("coord_tower"),
            tower("mega_tower"), img, tower("lc_tower"),
        ], dim=-1)
        r = self.router_drop(torch.tanh(self.router_fc1(all_feats)))
        router_weights = torch.sigmoid(self.router_fc2(r)).float()
        expert_outs = torch.stack(
            [getattr(self, f"expert_{i}")(all_feats) for i in range(self.num_experts)],
            dim=1).float()
        return topk_dense_dispatch(expert_outs, router_weights, k=2)


# the reference's 11 torch param groups: label -> (lr multiplier key, decay
# key, betas keys or None for beta1/beta2)
GROUP_SETTINGS = {
    "image_tower": ("cnn_lr", "cnn_decay", None),
    "psf_tower": ("psf_lr", "psf_decay", None),
    "lc_tower": ("lc_lr", "lc_decay", None),
    "mag_tower": ("mag_lr", "mag_decay", None),
    "spatial_tower": ("spatial_lr", "spatial_decay", None),
    # the reference gives the coord tower the nst1 settings, not the coord_*
    # keys it also defines
    "coord_tower": ("nst1_lr", "nst1_decay", None),
    "nst1_tower": ("nst1_lr", "nst1_decay", None),
    "nst2_tower": ("nst2_lr", "nst2_decay", None),
    "mega_tower": ("lc_lr", "lc_decay", None),
    "expert": ("fusion_lr", "fusion_decay", ("fusion_beta1", "fusion_beta2")),
    "router": ("router_lr", "router_decay", ("router_beta1", "router_beta2")),
}


def param_group_label(top_level_name: str) -> str:
    """The group of a top-level child: ``expert_*`` -> ``expert``,
    ``router_*`` -> ``router``, any other its own name."""
    if top_level_name.startswith("expert_"):
        return "expert"
    if top_level_name.startswith("router_"):
        return "router"
    return top_level_name


@register_model(name="AstroMiNN")
class AstroMiNNTask(Task):
    name = "AstroMiNN"

    def __init__(self, cfg: Config, device="cuda", generator: torch.Generator | None = None):
        super().__init__(cfg)
        mc = cfg["model"]["AstroMiNN"]
        self.mc = mc
        module = AstroMiNNModule(
            num_experts=int(mc["num_mlp_experts"]),
            towers_hidden_dims=int(mc["towers_hidden_dims"]),
            towers_outdims=int(mc["towers_outdims"]),
            fusion_hidden_dims=int(mc["fusion_hidden_dims"]),
            fusion_outdims=int(mc["fusion_outdims"]),
            moe_output_dims=int(mc.get("moe_output_dims", 5)),
            backbone_depths=tuple(mc.get("backbone_depths", (3, 3, 9, 3))),
            backbone_dims=tuple(mc.get("backbone_dims", (96, 192, 384, 768))),
            dtype=self.compute_dtype())
        self.module = init_weights(module, generator).to(resolve_device(device))

    def loss(self, batch, train: bool = True, kernels: bool = True):
        metadata, image, targets = batch
        self.module.train(train)
        logits = self.module(metadata, image)
        loss = cross_entropy(logits, targets)
        truth = targets.argmax(dim=-1) if targets.dim() > 1 else targets
        acc = (logits.argmax(dim=-1) == truth).float().mean()
        return loss, {"metrics": {"loss": loss, "accuracy": acc}, "logits": logits}

    def predict(self, batch, kernels: bool = True):
        self.module.eval()
        logits = self.module(batch[0], batch[1])
        return maybe_softmax(logits, bool(self.mc.get("use_probabilities", False)))

    def make_optimizer(self, params):
        """AdamW over the 11 groups of ``GROUP_SETTINGS``: lr ``base_lr`` x
        the group's multiplier, the group's weight decay, its own betas
        where it names them (else ``beta1``/``beta2``), eps ``eps``. Each
        parameter goes to the group of its top-level child's name; a
        parameter outside ``params`` (frozen: ``Trainer`` passes only the
        trainable ones) goes nowhere, and an empty group is dropped."""
        mc = self.mc
        base_lr = float(mc.get("base_lr", 1.6e-4))
        default_betas = (float(mc.get("beta1", 0.9)), float(mc.get("beta2", 0.999)))
        trainable = {id(p) for p in params}
        members: dict[str, list] = {label: [] for label in GROUP_SETTINGS}
        for name, p in self.module.named_parameters():
            if id(p) in trainable:
                members[param_group_label(name.split(".")[0])].append(p)
        groups = []
        for label, (lr_key, decay_key, betas_keys) in GROUP_SETTINGS.items():
            if not members[label]:
                continue
            betas = default_betas if betas_keys is None else \
                (float(mc[betas_keys[0]]), float(mc[betas_keys[1]]))
            groups.append({"params": members[label], "lr": base_lr * float(mc[lr_key]),
                           "weight_decay": float(mc[decay_key]), "betas": betas,
                           "label": label})
        return adamw(groups, base_lr, 0.0, default_betas, float(mc.get("eps", 5e-10)))

    @staticmethod
    def to_tensor(data_dict: dict) -> tuple[np.ndarray, ...]:
        """(metadata, NHWC images, one-hot targets) from an
        ``ImageAndMetadataDataset`` batch; NCHW images (1, 3 or 4 channels
        first, not last) become NHWC."""
        data = data_dict["data"]
        metadata = np.asarray(data["metadata"], dtype=np.float32)
        images = np.asarray(data["image"], dtype=np.float32)
        if images.ndim == 4 and images.shape[1] in (1, 3, 4) and images.shape[-1] not in (1, 3, 4):
            images = np.transpose(images, (0, 2, 3, 1))
        targets = np.asarray(data.get("target", []), dtype=np.float32)
        return (metadata, images, targets)


register_model(AstroMiNNTask, name="applecider_tpu.models.astrominn.AstroMiNNTask")
