"""``applecider-import-checkpoint-torch``: bring a reference (PyTorch)
checkpoint into the port (counterpart of
``applecider_tpu/utils/import_checkpoint.py``, which writes an orbax
checkpoint for the JAX package).

It loads a ``torch.save``'d state_dict of one model family, maps it onto
the port's names with ``utils.torch_port`` (detecting the reference
modules' own layouts as the JAX importer does), checks every name and
shape against a fresh port task built from the config, and writes
``<run>/checkpoints/<tag>.pt`` as ``{"params": state_dict}``, the layout
that ``Trainer.restore_weights``, ``AppleCiderRuntime.infer``/``serve`` and
``applecider-serve-torch`` read::

    applecider-import-checkpoint-torch --model SpectraNet --ckpt ref.pt \\
        --out runs/imported [--config run.toml] [--tag best]
    applecider-import-checkpoint-torch --model AppleCider --ckpt ref.pt \\
        --workdir results --config run.toml   # results/<stamp>-train-AppleCider

``--workdir`` writes a run directory named as ``AppleCiderRuntime.train``
names its own, so the runtime's verbs and the serving CLI on that workdir
take the imported weights as the latest trained run.

Models: BaselineCLS, MPT, SpectraNet, SpectraNetTriPool, AstroMiNN, and the
fusion model (AppleCider or Fusion) in the canonical layout
(``img_meta_encoder.*``) or the reference's (``img_metadata_encoder.*``,
which needs ``model.AppleCider.spectra_encoder = "tripool"``). A missing,
unexpected or misshapen name, and an entry of the checkpoint that no name
of the model reads (a layer beyond the configured depth), is an error that
lists them all; nothing is filled in from a fresh init.
"""

from __future__ import annotations

import argparse
import datetime as _dt
import json
import re
import warnings
from pathlib import Path
from typing import Mapping

import torch

from applecider_tpu_torch.config import Config, load_config
from applecider_tpu_torch.registry import get_model
from applecider_tpu_torch.utils import torch_port

MODELS = ("BaselineCLS", "MPT", "SpectraNet", "SpectraNetTriPool", "AstroMiNN", "AppleCider",
          "Fusion")
# entries no port model reads: BatchNorm's counter, the fusion SpectraNet
# classifier's last layer (its embedding stops before it), timm's classifier
UNREAD_OK = re.compile(r"num_batches_tracked$|^spectra_encoder\.classifier\.4\.|\bhead\.fc\.")


def load_state_dict(path: str | Path) -> dict:
    """A ``torch.save``'d state_dict, or one under ``"state_dict"``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    return dict(sd)


def convert(sd: Mapping, model: str, cfg: Config) -> dict[str, torch.Tensor]:
    """A reference state_dict of ``model`` as the port's state_dict."""
    keys = set(sd)
    pc, mc = cfg["model"]["BaselineCLS"], cfg["model"]
    if model == "BaselineCLS":
        return torch_port.baseline_cls_sd(sd, int(pc["n_layers"]),
                                          classification=pc.get("mode", "photo") == "photo")
    if model == "MPT":
        return torch_port.mpt_sd(sd, int(pc["n_layers"]))
    if model == "SpectraNet":
        sc = mc["SpectraNet"]
        if any(k.startswith("stage1.") for k in keys):  # the reference's own layout
            sd = torch_port.rename_reference_spectranet_sd(sd)
        return torch_port.spectranet_sd(sd, list(sc["depths"]),
                                        [len(k) for k in sc["kernel_sizes_per_stage"]])
    if model == "SpectraNetTriPool":
        depths = list(dict(mc.get("SpectraNetTriPool", {})).get("depths", [1] * 5))
        return torch_port.spectranet_tripool_sd(sd, depths)
    ac = mc["AstroMiNN"]
    depths = tuple(ac.get("backbone_depths", (3, 3, 9, 3)))
    experts = int(ac.get("num_mlp_experts", 4))
    if model == "AstroMiNN":
        if any(k.startswith("fusion_experts.") for k in keys):  # the reference's own layout
            sd = torch_port.rename_reference_astrominn_sd(sd)
        return torch_port.astrominn_sd(sd, depths, experts)
    if model in ("AppleCider", "Fusion"):
        if any(k.startswith("img_metadata_encoder.") for k in keys):  # the reference's own
            tc = dict(mc.get("SpectraNetTriPool", {}))
            return torch_port.fusion_reference_sd(
                sd, photometry_layers=int(pc["n_layers"]),
                spectra_depths=tuple(tc.get("depths", (1,) * 5)),
                astrominn_backbone_depths=depths, num_experts=experts)
        sc = mc["SpectraNet"]
        return torch_port.fusion_sd(
            sd, photometry_layers=int(pc["n_layers"]), spectranet_depths=list(sc["depths"]),
            spectranet_kernels_per_stage=[len(k) for k in sc["kernel_sizes_per_stage"]],
            astrominn_backbone_depths=depths, num_experts=experts)
    raise ValueError(f"unknown --model {model!r}; one of {', '.join(MODELS)}")


def fresh_module(model: str, cfg: Config) -> torch.nn.Module:
    """The port's module of ``model`` as the config builds it, on the CPU."""
    built = get_model(model)(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return getattr(built, "module", built)


def check_against(module: torch.nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Raise ``ValueError`` listing every name ``state`` lacks, has beyond
    ``module``'s state_dict, or holds at another shape."""
    want = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    misshapen = sorted(f"{k}: {got[k]} (the config builds {want[k]})"
                       for k in set(want) & set(got) if want[k] != got[k])
    if not (missing or unexpected or misshapen):
        return
    lines = ["the checkpoint does not match the model the config builds:"]
    for what, names in (("missing", missing), ("unexpected", unexpected),
                        ("misshapen", misshapen)):
        if names:
            lines.append(f"  {what} ({len(names)}): " + ", ".join(names))
    if any(n.endswith(".running_mean") for n in missing + unexpected):
        use_ln = [not any(n.endswith(f"stage{s}_block0.norm.running_mean") for n in state)
                  for s in range(5)]
        lines.append("  TriPool's BatchNorm stages are the ones with running statistics: "
                     f"model.SpectraNetTriPool.use_ln_stages = {json.dumps(use_ln)}")
    raise ValueError("\n".join(lines))


def follow_tripool_layout(sd: Mapping, model: str, cfg: Config) -> None:
    """Set ``model.SpectraNetTriPool.use_ln_stages`` in ``cfg`` to the norm
    layout a TriPool checkpoint in the reference's names carries
    (``torch_port.tripool_use_ln``), as the JAX importer follows the
    checkpoint: the SpectraNetTriPool model, and the reference's own fusion
    layout. A layout the config names and the checkpoint contradicts is
    replaced, with a warning that names both; any other model is left
    alone."""
    if model == "SpectraNetTriPool":
        spectra = sd
    elif model in ("AppleCider", "Fusion") and any(k.startswith("img_metadata_encoder.")
                                                   for k in sd):
        spectra = torch_port._sub(sd, "spectra_encoder")
    else:
        return
    tc = dict(cfg["model"].get("SpectraNetTriPool", {}))
    n_stages = len(tc.get("depths", tc.get("channels", (1,) * 5)))
    inferred = torch_port.tripool_use_ln(spectra, n_stages)
    named = tc.get("use_ln_stages")
    if named is not None and [bool(v) for v in named] != inferred:
        warnings.warn(f"model.SpectraNetTriPool.use_ln_stages = {json.dumps(list(named))} "
                      f"disagrees with the checkpoint's norm layout {json.dumps(inferred)} (a stage "
                      "with running statistics is BatchNorm); the checkpoint's layout builds the "
                      "model", stacklevel=2)
    cfg.set("model.SpectraNetTriPool.use_ln_stages", inferred)


def import_checkpoint(sd: Mapping, model: str, cfg: Config) -> dict[str, torch.Tensor]:
    """``convert`` then ``check_against`` a fresh port module of ``model``;
    also loads it into that module, strictly. A TriPool checkpoint's norm
    layout is read from it first (``follow_tripool_layout``, which sets it
    in ``cfg``)."""
    follow_tripool_layout(sd, model, cfg)
    try:
        with torch_port.reading() as read:
            state = convert(sd, model, cfg)
    except KeyError as e:
        sample = ", ".join(sorted(sd)[:5])
        raise ValueError(f"the checkpoint does not look like a {model} state_dict (missing "
                         f"key {e}); its keys start with: {sample} ...") from e
    module = fresh_module(model, cfg)
    check_against(module, state)
    unread = sorted(k for k, v in sd.items() if id(v) not in read and not UNREAD_OK.search(k))
    if unread:
        raise ValueError(f"the model the config builds reads no entry of the checkpoint named "
                         f"({len(unread)}): {', '.join(unread)}")
    module.load_state_dict(state, strict=True)
    return state


def run_dir_for(workdir: str | Path, model: str) -> Path:
    """A run directory under ``workdir`` named as ``AppleCiderRuntime`` names
    a trained run, so its verbs find it."""
    stamp = _dt.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
    run = Path(workdir) / f"{stamp}-train-{model}"
    run.mkdir(parents=True, exist_ok=True)
    (run / "run.json").write_text(json.dumps({"verb": "import", "model": model,
                                              "timestamp": stamp}))
    return run


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", required=True, choices=MODELS)
    ap.add_argument("--ckpt", required=True, help="torch .pt state_dict")
    out = ap.add_mutually_exclusive_group(required=True)
    out.add_argument("--out", help="run directory to write <out>/checkpoints/<tag>.pt into")
    out.add_argument("--workdir", help="results root: writes a new <stamp>-train-<model> run")
    ap.add_argument("--config", default=None, help="run TOML (defaults applied otherwise)")
    ap.add_argument("--tag", default="best", help="checkpoint tag (default: best)")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    try:
        state = import_checkpoint(load_state_dict(args.ckpt), args.model, cfg)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    run = Path(args.out) if args.out else run_dir_for(args.workdir, args.model)
    path = run / "checkpoints" / f"{args.tag}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": state}, path)
    print(f"imported {args.model} checkpoint -> {path} "
          f"({sum(v.numel() for v in state.values())} values)")
    return path


if __name__ == "__main__":
    main()
