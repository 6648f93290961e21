"""Plain reference of the ``applecider_fusion`` configuration: the
AppleCider four-modality late-fusion classifier (arXiv:2507.16088).

The photometry transformer, SpectraNet's embedding and AstroMiNN each give
an embedding; each is projected to ``hidden_dim``, L2-normalised, the three
are averaged and a Linear layer gives the class logits. Training minimises
the cross entropy with Adam, the gradients clipped to a global norm.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import layers as L


class Fusion(L.Ref):
    def __init__(self, cfg: dict):
        super().__init__()
        p, s, a, f = (cfg["model"][k] for k in ("BaselineCLS", "SpectraNet", "AstroMiNN",
                                                 "AppleCider"))
        self.photometry_encoder = L.BaselineCLS(p["d_model"], p["n_heads"], p["n_layers"],
                                                p["dropout"])
        self.spectra_encoder = L.SpectraNet(s["channels"], s["depths"],
                                            s["kernel_sizes_per_stage"], s.get("head_hidden", 384))
        self.img_meta_encoder = L.AstroMiNN(
            a["num_mlp_experts"], a["towers_hidden_dims"], a["towers_outdims"],
            a["fusion_hidden_dims"], a["fusion_outdims"], a["moe_output_dims"],
            a["backbone_depths"], a["backbone_dims"])
        h = f["hidden_dim"]
        self.photometry_proj = L.Linear(p["d_model"], h)
        self.spectra_proj = L.Linear(s.get("head_hidden", 384), h)
        self.img_metadata_proj = L.Linear(a["moe_output_dims"], h)
        self.fc = L.Linear(h, f["num_classes"])

    def forward(self, photometry, pad, metadata, images, spectra):
        p = L.l2_normalize(self.photometry_proj(self.photometry_encoder(photometry, pad)))
        s = L.l2_normalize(self.spectra_proj(self.spectra_encoder(spectra)))
        im = L.l2_normalize(self.img_metadata_proj(self.img_meta_encoder(metadata, images)))
        return self.fc((p + im + s) / 3.0)


def build(cfg: dict) -> Fusion:
    return Fusion(cfg)


def serve_batch(inputs: list[dict], device) -> tuple:
    """``preprocess.alert_inputs`` of a block of alerts as padded tensors."""
    n = max(len(x["photometry"]) for x in inputs)
    photometry = np.zeros((len(inputs), n, 7))
    pad = np.ones((len(inputs), n), bool)
    for i, x in enumerate(inputs):
        photometry[i, : len(x["photometry"])] = x["photometry"]
        pad[i, : len(x["photometry"])] = False
    stack = [np.stack([x[k] for x in inputs]) for k in ("metadata", "image", "spectrum")]
    t = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in (photometry, *stack)]
    return t[0], torch.as_tensor(pad, device=device), t[1], t[2], t[3]


def train_batch(samples: list[dict], max_len: int, device) -> tuple:
    """Training samples as tensors: light curves padded to ``max_len``
    (True = padded), the four continuous channels standardised by the
    samples' ``mean`` and ``std``; the labels last."""
    B = len(samples)
    photometry = np.zeros((B, max_len, 7), np.float32)
    pad = np.ones((B, max_len), bool)
    for i, s in enumerate(samples):
        n = min(len(s["photometry"]), max_len)
        photometry[i, :n] = s["photometry"][:n]
        pad[i, :n] = False
    photometry[..., :4] = (photometry[..., :4] - samples[0]["mean"]) / (samples[0]["std"] + 1e-8)
    arrays = [photometry] + [np.stack([s[k] for s in samples]).astype(np.float32)
                             for k in ("metadata", "image", "spectrum")]
    t = [torch.as_tensor(a, device=device) for a in arrays]
    labels = torch.as_tensor(np.asarray([s["label"] for s in samples], np.int64), device=device)
    return t[0], torch.as_tensor(pad, device=device), t[1], t[2], t[3], labels


def loss(model: Fusion, batch: tuple) -> torch.Tensor:
    logits = model(*batch[:5])
    return torch.nn.functional.cross_entropy(logits, batch[5])


def optimizer(cfg: dict) -> dict:
    f = cfg["model"]["AppleCider"]
    return {"lr": f["lr"], "weight_decay": 0.0, "grad_clip": f["grad_clip"]}


# ------------------------------------------------------------------ FLOPs
def dense(n: float, fin: int, fout: int) -> float:
    return 2.0 * n * fin * fout


def photometry_flops(cfg: dict, points: int) -> float:
    """The transformer over ``points`` events and the CLS token."""
    p = cfg["model"]["BaselineCLS"]
    d, L_ = p["d_model"], points + 1
    per_layer = (dense(L_, d, 3 * d) + 4.0 * L_ * L_ * d + dense(L_, d, d)
                 + dense(L_, d, 4 * d) + dense(L_, 4 * d, d))
    return dense(points, 7, d) + p["n_layers"] * per_layer


def spectra_flops(cfg: dict, classes: int | None = None, bins: int = 3481) -> float:
    """SpectraNet's banks as direct 'same' convolutions, the 1x1
    downsamples and the head."""
    s = cfg["model"]["SpectraNet"]
    total, cin, length = 0.0, 1, bins
    last = len(s["channels"]) - 1
    for st, (cout, ks) in enumerate(zip(s["channels"], s["kernel_sizes_per_stage"])):
        for d in range(s["depths"][st]):
            total += sum(2.0 * length * cin * cout * k for k in ks)
            cin = cout * len(ks)
            if st != last and d == s["depths"][st] - 1:
                total += dense(length, cin, cout)
                cin, length = cout, length // 4
    hidden = s.get("head_hidden", 384)
    total += dense(1, cin, hidden)
    return total + (dense(1, hidden, classes) if classes else 0.0)


def convnext_flops(depths, dims, hw: int = 63) -> float:
    n = hw // 4
    total = dense(n * n, 3 * 16, dims[0])
    for s, depth in enumerate(depths):
        if s:
            cin, n = dims[s - 1], n // 2
            total += dense(n * n, 4 * cin, dims[s])
        d = dims[s]
        total += depth * (2.0 * n * n * d * 49 + 2 * dense(n * n, d, 4 * d))
    return total


def tower_flops(fin: int, hidden: int, out: int) -> float:
    return (dense(1, fin, hidden) + 2 * dense(1, hidden, out)
            + (dense(1, fin, out) if fin != out else 0.0))


def img_meta_flops(cfg: dict) -> float:
    a = cfg["model"]["AstroMiNN"]
    th, to, fo = a["towers_hidden_dims"], a["towers_outdims"], a["fusion_outdims"]
    sizes = {"nst1_tower": (th, fo), "nst2_tower": (th, fo), "spatial_tower": (th, to),
             "psf_tower": (th, to), "mag_tower": (2 * th, to), "coord_tower": (th, fo),
             "mega_tower": (128, to), "lc_tower": (3 * th, to)}
    total = sum(tower_flops(len(cols), *sizes[name]) for name, cols in L.TOWERS)
    f = a["backbone_dims"][-1]
    total += convnext_flops(a["backbone_depths"], a["backbone_dims"])
    total += dense(1, f, f // 2) + dense(1, f // 2, f) + dense(1, f, to) + dense(1, f, to)
    width = 6 * to + 3 * fo
    total += dense(1, width, width // 2) + dense(1, width // 2, a["num_mlp_experts"])
    total += a["num_mlp_experts"] * tower_flops(width, a["fusion_hidden_dims"],
                                                a["moe_output_dims"])
    return total + 2.0 * a["num_mlp_experts"] * a["moe_output_dims"]  # the gated sum


def head_flops(cfg: dict) -> float:
    p, s, a, f = (cfg["model"][k] for k in ("BaselineCLS", "SpectraNet", "AstroMiNN",
                                             "AppleCider"))
    h = f["hidden_dim"]
    return (dense(1, p["d_model"], h) + dense(1, s.get("head_hidden", 384), h)
            + dense(1, a["moe_output_dims"], h) + dense(1, h, f["num_classes"]))


def forward_flops(cfg: dict, points: int, has_spectrum: bool) -> float:
    """Model FLOPs of one sample's forward: its own light-curve length, and
    SpectraNet only where it carries a spectrum (multiply-adds count 2)."""
    return (photometry_flops(cfg, points) + img_meta_flops(cfg) + head_flops(cfg)
            + (spectra_flops(cfg) if has_spectrum else 0.0))
