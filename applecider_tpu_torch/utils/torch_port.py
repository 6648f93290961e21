"""Map the reference architectures' PyTorch ``state_dict``s onto the port's
(counterpart of ``applecider_tpu/utils/torch_port.py``, which maps them
onto flax parameters).

The port's layers keep PyTorch's layouts (``Linear`` (out, in), ``Conv1d``
(out, in, k), ``Conv2d`` OIHW, LayerNorm's ``weight`` and ``bias``), so
each mapping here is a change of names and every array is taken as it is:

* the fused q, k, v projection, ``self_attn.in_proj_weight`` (3 d, d) and
  ``in_proj_bias`` (q rows, then k, then v), is the port's
  ``self_attn.in_proj.weight`` and ``.bias`` unchanged (the JAX package
  transposes it into a (d, 3 d) kernel);
* Time2Vec's ``w0``, ``b0``, ``w``, ``b`` keep their names and shapes;
* TriPool's frozen BatchNorm keeps ``running_mean`` and ``running_var`` as
  the module's buffers of those names (the JAX package moves them to its
  ``batch_stats`` collection); ``num_batches_tracked`` is not read.

Inputs are ``{name: array}`` dicts of NumPy arrays or tensors; outputs are
``{name: float32 tensor}`` dicts in the port's names. A missing key raises
``KeyError``; inside ``reading()`` every array taken is recorded, so that
a caller can name the entries a mapping left unread. Two layouts are read
for each family where the reference has two: the canonical one of the
numeric oracles (``tests/torch_refs.py``) and the reference modules' own
``nn.Sequential`` names, which ``rename_reference_spectranet_sd``,
``rename_reference_astrominn_sd`` and ``rename_timm_convnext_sd`` turn
into the canonical one. The fusion model's SpectraNet embedding stops
before the classifier's last layer, so ``fusion_sd`` leaves out the unused
``classifier.4`` a reference fusion checkpoint carries.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Iterator, Mapping, Sequence

import numpy as np
import torch

from applecider_tpu_torch.models.mpt import warmstart_classifier_params

TOWERS = ("nst1_tower", "nst2_tower", "spatial_tower", "psf_tower", "mag_tower", "coord_tower",
          "mega_tower", "lc_tower")


_READ: contextvars.ContextVar[set | None] = contextvars.ContextVar("torch_port_read",
                                                                 default=None)


@contextlib.contextmanager
def reading() -> Iterator[set]:
    """Within the block the ``id`` of every input array a mapping takes is
    added to the set yielded (renames keep the arrays, so the ids are the
    caller's)."""
    read: set = set()
    token = _READ.set(read)
    try:
        yield read
    finally:
        _READ.reset(token)


def _tensor(v) -> torch.Tensor:
    read = _READ.get()
    if read is not None:
        read.add(id(v))
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return torch.from_numpy(np.array(np.asarray(v, np.float32), order="C"))


def _copy(sd: Mapping, src: str, dst: str, out: dict, optional: bool = False) -> None:
    if optional and src not in sd:
        return
    out[dst] = _tensor(sd[src])


def _affine(sd: Mapping, src: str, dst: str, out: dict) -> None:
    """A Linear, conv or norm layer: its ``weight`` and, where it has one,
    its ``bias``."""
    _copy(sd, f"{src}.weight", f"{dst}.weight", out)
    _copy(sd, f"{src}.bias", f"{dst}.bias", out, optional=True)


def _sub(sd: Mapping, prefix: str) -> dict:
    """The entries under ``prefix.``, without it."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _prefixed(prefix: str, sd: Mapping) -> dict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


# ----------------------------------------------------------- photometry
def _encoder_layer(sd: Mapping, src: str, dst: str, out: dict) -> None:
    """``nn.TransformerEncoderLayer`` -> ``layers.TransformerEncoderLayer``."""
    _copy(sd, f"{src}.self_attn.in_proj_weight", f"{dst}.self_attn.in_proj.weight", out)
    _copy(sd, f"{src}.self_attn.in_proj_bias", f"{dst}.self_attn.in_proj.bias", out)
    for name in ("self_attn.out_proj", "linear1", "linear2", "norm1", "norm2"):
        _affine(sd, f"{src}.{name}", f"{dst}.{name}", out)


def _trunk(sd: Mapping, n_layers: int, out: dict) -> None:
    """The BaselineCLS trunk shared with MPT: ``in_proj``, ``cls_tok``,
    ``time2vec``, ``encoder.layers.{i}`` -> ``trunk.*``."""
    _affine(sd, "in_proj", "trunk.in_proj", out)
    _copy(sd, "cls_tok", "trunk.cls_tok", out)
    for k in ("w0", "b0", "w", "b"):
        _copy(sd, f"time2vec.{k}", f"trunk.time2vec.{k}", out)
    for i in range(n_layers):
        _encoder_layer(sd, f"encoder.layers.{i}", f"trunk.encoder.layer_{i}", out)


def baseline_cls_sd(sd: Mapping, n_layers: int, classification: bool = True) -> dict:
    """BaselineCLS (its ``fc`` with ``classification``, where present)."""
    out: dict = {}
    _trunk(sd, n_layers, out)
    _affine(sd, "norm", "norm", out)
    if classification and "fc.weight" in sd:
        _affine(sd, "fc", "fc", out)
    return out


def mpt_sd(sd: Mapping, n_layers: int) -> dict:
    """The MPT pretrainer: the trunk and its three heads."""
    out: dict = {}
    _trunk(sd, n_layers, out)
    for head in ("head_flux", "head_band", "head_dt"):
        _affine(sd, head, head, out)
    return out


def mpt_to_classifier_warmstart(classifier_sd: Mapping[str, torch.Tensor],
                                mpt_state: Mapping[str, torch.Tensor]) -> dict:
    """The reference's weight surgery (baselineCLS_example.py:31-39) on an
    imported MPT: ``classifier_sd`` with the pretrained ``trunk.*``."""
    return warmstart_classifier_params(classifier_sd, mpt_state)


# -------------------------------------------------------------- spectra
def spectranet_sd(sd: Mapping, depths: Sequence[int], n_kernels_per_stage: Sequence[int],
                  embedding: bool = False) -> dict:
    """SpectraNet in the canonical layout (``stages.{s}.{d}.convs.{i}``,
    ``norm``, ``downsample``; head ``classifier.{0,1,4}``); with
    ``embedding`` the head stops at ``classifier.1``, as the fusion
    model's encoder does."""
    out: dict = {}
    for s, depth in enumerate(depths):
        for d in range(int(depth)):
            src, dst = f"stages.{s}.{d}", f"stage{s}_block{d}"
            for i in range(int(n_kernels_per_stage[s])):
                _affine(sd, f"{src}.convs.{i}", f"{dst}.conv_{i}", out)
            _affine(sd, f"{src}.norm", f"{dst}.norm", out)
            if f"{src}.downsample.weight" in sd:
                _affine(sd, f"{src}.downsample", f"{dst}.downsample", out)
    _affine(sd, "classifier.0", "head_fc1", out)
    _affine(sd, "classifier.1", "head_norm", out)
    if not embedding:
        _affine(sd, "classifier.4", "head_fc2", out)
    return out


def spectranet_tripool_sd(sd: Mapping, depths: Sequence[int]) -> dict:
    """brew_cider's TriPool SpectraNet (``stage{k}.{d}.{convs.{i}, proj,
    norm}``, head ``class_model.{0,1,4,5}``, ``fc`` where present). A stage
    whose norm carries ``running_mean`` is a frozen BatchNorm: its
    statistics become the buffers of the same names."""
    out: dict = {}
    for s, depth in enumerate(depths):
        for d in range(int(depth)):
            src, dst = f"stage{s + 1}.{d}", f"stage{s}_block{d}"
            for i in range(3):
                _affine(sd, f"{src}.convs.{i}", f"{dst}.conv_{i}", out)
            _affine(sd, f"{src}.proj", f"{dst}.proj", out)
            _affine(sd, f"{src}.norm", f"{dst}.norm", out)
            for stat in ("running_mean", "running_var"):
                _copy(sd, f"{src}.norm.{stat}", f"{dst}.norm.{stat}", out, optional=True)
    for src, dst in (("class_model.0", "head_fc1"), ("class_model.1", "head_norm1"),
                     ("class_model.4", "head_fc2"), ("class_model.5", "head_norm2")):
        _affine(sd, src, dst, out)
    if "fc.weight" in sd:
        _affine(sd, "fc", "fc", out)
    return out


def tripool_use_ln(sd: Mapping, n_stages: int) -> list[bool]:
    """The norm layout of a TriPool state_dict in the reference's names, as
    the JAX package reads it: stage s is BatchNorm exactly when
    ``stage{s + 1}.0.norm.running_mean`` is present, else LayerNorm."""
    return [f"stage{s + 1}.0.norm.running_mean" not in sd for s in range(n_stages)]


def rename_reference_spectranet_sd(sd: Mapping) -> dict:
    """``stage{k}.{d}.*`` (build_spec_model, SpectraNet.py:9-114) ->
    ``stages.{k-1}.{d}.*``; the other names already align."""
    out = {}
    for k, v in sd.items():
        if k.startswith("stage") and k[5].isdigit():
            stage_no, rest = k[5:].split(".", 1)
            out[f"stages.{int(stage_no) - 1}.{rest}"] = v
        else:
            out[k] = v
    return out


# -------------------------------------------------------- image+metadata
def rename_timm_convnext_sd(sd: Mapping) -> dict:
    """timm ``convnext_tiny`` names (``stem.0/1``, ``stages.S.blocks.B.{conv_dw,
    norm, mlp.fc1, mlp.fc2, gamma}``, ``stages.S.downsample.{0,1}``,
    ``head.norm``) -> the canonical ConvNeXt layout (``stem_conv``,
    ``stem_norm``, ``stages.S.B.{dwconv, norm, pwconv1, pwconv2, gamma}``,
    ``downsamples.{S-1}.{norm, conv}``, ``head_norm``); timm's classifier
    (``head.fc``, absent at ``num_classes=0``) is not read."""
    out = {}
    for k, v in sd.items():
        nk = k.replace("stem.0.", "stem_conv.").replace("stem.1.", "stem_norm.")
        m = re.match(r"stages\.(\d+)\.downsample\.(\d+)\.(.*)", nk)
        if m:
            s, i, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            nk = f"downsamples.{s - 1}.{'norm' if i == 0 else 'conv'}.{rest}"
        nk = re.sub(r"stages\.(\d+)\.blocks\.(\d+)\.", r"stages.\1.\2.", nk)
        nk = nk.replace(".conv_dw.", ".dwconv.")
        nk = nk.replace(".mlp.fc1.", ".pwconv1.").replace(".mlp.fc2.", ".pwconv2.")
        nk = nk.replace("head.norm.", "head_norm.").replace("norm_pre.", "head_norm.")
        if not nk.startswith("head."):
            out[nk] = v
    return out


def convnext_sd(sd: Mapping, depths: Sequence[int]) -> dict:
    """ConvNeXt in the canonical layout, or in timm's (detected by its
    ``stem.0.weight``)."""
    if "stem.0.weight" in sd:
        sd = rename_timm_convnext_sd(sd)
    out: dict = {}
    for name in ("stem_conv", "stem_norm", "head_norm"):
        _affine(sd, name, name, out)
    for s, depth in enumerate(depths):
        if s > 0:
            _affine(sd, f"downsamples.{s - 1}.norm", f"downsample{s}_norm", out)
            _affine(sd, f"downsamples.{s - 1}.conv", f"downsample{s}_conv", out)
        for b in range(int(depth)):
            src, dst = f"stages.{s}.{b}", f"stage{s}_block{b}"
            for name in ("dwconv", "norm", "pwconv1", "pwconv2"):
                _affine(sd, f"{src}.{name}", f"{dst}.{name}", out)
            _copy(sd, f"{src}.gamma", f"{dst}.gamma", out)
    return out


def _tower(sd: Mapping, src: str, dst: str, out: dict) -> None:
    for name in ("start", "gate_norm", "gate_fc", "main_norm", "main_fc"):
        _affine(sd, f"{src}.{name}", f"{dst}.{name}", out)
    if f"{src}.skip.weight" in sd:
        _affine(sd, f"{src}.skip", f"{dst}.skip", out)


def astrominn_sd(sd: Mapping, backbone_depths: Sequence[int], num_experts: int = 4) -> dict:
    """AstroMiNN in the canonical layout (the towers, ``image_tower`` with
    its ConvNeXt ``backbone`` in either layout, ``router_fc1/2``,
    ``experts.{i}``)."""
    out: dict = {}
    for tower in TOWERS:
        _tower(sd, tower, tower, out)
    backbone = convnext_sd(_sub(sd, "image_tower.backbone"), backbone_depths)
    out.update(_prefixed("image_tower.backbone", backbone))
    for name in ("main_norm", "main_fc1", "main_fc2", "main_fc3", "aux_norm", "aux_fc"):
        _affine(sd, f"image_tower.{name}", f"image_tower.{name}", out)
    _affine(sd, "router_fc1", "router_fc1", out)
    _affine(sd, "router_fc2", "router_fc2", out)
    for i in range(num_experts):
        _tower(sd, f"experts.{i}", f"expert_{i}", out)
    return out


_TOWER_NAMES = {"start_path.0": "start", "activation.0": "gate_norm", "activation.2": "gate_fc",
                "main_path.0": "main_norm", "main_path.2": "main_fc", "skip_path": "skip"}


def _rename_tower(rest: str) -> str:
    """ResidualTowerBlock's ``nn.Sequential`` names -> the canonical ones."""
    for src, dst in _TOWER_NAMES.items():
        if rest.startswith(src + "."):
            return dst + rest[len(src):]
    return rest


def rename_reference_astrominn_sd(sd: Mapping) -> dict:
    """The reference AstroMiNN / XastroMiNN (src astrominn.py:67-218,
    _archive AstroMiNN.py:1575-1728) -> the canonical layout; the image
    backbone stays under ``image_tower.backbone.*`` in whichever layout it
    came (``convnext_sd`` reads timm's)."""
    head_main = {"1": "main_norm", "2": "main_fc1", "5": "main_fc2", "6": "main_fc3"}
    head_aux = {"0": "aux_norm", "1": "aux_fc"}
    out = {}
    for k, v in sd.items():
        if k.startswith("fusion_router.0."):
            out["router_fc1." + k[len("fusion_router.0."):]] = v
        elif k.startswith("fusion_router.3."):
            out["router_fc2." + k[len("fusion_router.3."):]] = v
        elif k.startswith("fusion_experts."):
            idx, rest = k[len("fusion_experts."):].split(".", 1)
            out[f"experts.{idx}." + _rename_tower(rest)] = v
        elif k.startswith("image_tower.head_main."):
            idx, rest = k[len("image_tower.head_main."):].split(".", 1)
            out[f"image_tower.{head_main[idx]}.{rest}"] = v
        elif k.startswith("image_tower.head_aux."):
            idx, rest = k[len("image_tower.head_aux."):].split(".", 1)
            out[f"image_tower.{head_aux[idx]}.{rest}"] = v
        elif any(k.startswith(t + ".") for t in TOWERS):
            tower, rest = k.split(".", 1)
            out[f"{tower}." + _rename_tower(rest)] = v
        else:
            out[k] = v
    return out


# --------------------------------------------------------------- fusion
def _fusion_heads(sd: Mapping, out: dict) -> dict:
    for name in ("photometry_proj", "spectra_proj", "img_metadata_proj", "fc"):
        _affine(sd, name, name, out)
    return out


def fusion_sd(sd: Mapping, *, photometry_layers: int, spectranet_depths: Sequence[int],
              spectranet_kernels_per_stage: Sequence[int],
              astrominn_backbone_depths: Sequence[int], num_experts: int = 4) -> dict:
    """The whole fusion model in the canonical layout
    (``tests/torch_refs.TorchAppleCider``: ``photometry_encoder.*``,
    ``spectra_encoder.*`` a standard SpectraNet, ``img_meta_encoder.*``, the
    three projections and ``fc``)."""
    out: dict = {}
    out.update(_prefixed("photometry_encoder", baseline_cls_sd(
        _sub(sd, "photometry_encoder"), photometry_layers, classification=False)))
    out.update(_prefixed("spectra_encoder", spectranet_sd(
        _sub(sd, "spectra_encoder"), spectranet_depths, spectranet_kernels_per_stage,
        embedding=True)))
    out.update(_prefixed("img_meta_encoder", astrominn_sd(
        _sub(sd, "img_meta_encoder"), astrominn_backbone_depths, num_experts)))
    return _fusion_heads(sd, out)


def fusion_reference_sd(sd: Mapping, *, photometry_layers: int,
                        spectra_depths: Sequence[int] = (1, 1, 1, 1, 1),
                        astrominn_backbone_depths: Sequence[int] = (3, 3, 9, 3),
                        num_experts: int = 4) -> dict:
    """The reference's own fusion checkpoint (brew_cider.py:807-862):
    ``photometry_encoder.*``, ``spectra_encoder.*`` a TriPool SpectraNet,
    ``img_metadata_encoder.*`` in XastroMiNN's ``nn.Sequential`` names, the
    projections and ``fc``. It runs with ``model.AppleCider.spectra_encoder
    = "tripool"``."""
    out: dict = {}
    out.update(_prefixed("photometry_encoder", baseline_cls_sd(
        _sub(sd, "photometry_encoder"), photometry_layers, classification=False)))
    out.update(_prefixed("spectra_encoder", spectranet_tripool_sd(
        _sub(sd, "spectra_encoder"), spectra_depths)))
    out.update(_prefixed("img_meta_encoder", astrominn_sd(
        rename_reference_astrominn_sd(_sub(sd, "img_metadata_encoder")),
        astrominn_backbone_depths, num_experts)))
    return _fusion_heads(sd, out)
