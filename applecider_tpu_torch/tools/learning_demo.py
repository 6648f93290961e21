"""Training LEARNS, end to end: the JAX package's learning demonstration
(``scripts/learning_demo.py``) in the port.

On a learnable synthetic corpus (every modality conditioned on the class,
a BTS-like class balance: ``testing.make_corpus(learnable=True,
class_weights=BTS_CLASS_WEIGHTS)``), for each seed:

1. MPT self-supervised pretraining on the photometry events;
2. weight surgery (``warmstart_classifier_params``), then the BaselineCLS
   classifier fine-tuned from it beside one trained cold, with
   oversampling, a plateau schedule and early stopping;
3. the 4-modality fusion model trained with oversampling, EMA and a
   plateau schedule;
4. per-seed test metrics, the fusion model's confusion matrix, and the
   mean and standard deviation over seeds.

Writes ``summary.json``, ``metrics_seed<i>.jsonl`` (the fusion run's
history) and ``confusion_fusion.png`` (seed 0's fusion test set, drawn
from the summary's confusion counts by ``utils/plots.py``; where
matplotlib is missing, as on the card's machine, ``--plot-only`` draws it
afterwards) into ``--outdir``; each seed's record carries its seconds. ``--quick`` shrinks the corpus (80
objects) and the epochs (8) as the JAX script's does. Runs on the card
unless ``--device cpu`` is given:

    python3 -m applecider_tpu_torch.tools.learning_demo --outdir results/h100/learning_demo

``run(outdir, seeds, n_objects, epochs, device, mpt_epochs=)`` is the
library entry (a CPU test runs it at a few objects and one epoch).
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

PROTOCOL = ("MPT pretrain -> surgery -> finetune (vs cold); fusion with oversampling+EMA+plateau; "
            "BTS-imbalanced learnable synthetic corpus")
CHANCE = 0.2  # five classes


def _numbers(report: dict) -> dict:
    return {k: v for k, v in report.items() if isinstance(v, (int, float))}


def run_seed(root: Path, seed: int, n_objects: int, epochs: int, device="cuda",
             mpt_epochs: int | None = None) -> dict:
    """One seed of the protocol in ``root`` (a scratch directory); MPT
    pretrains for ``mpt_epochs`` (the JAX script's max(8, epochs // 2) by
    default)."""
    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.datasets.fusion_dataset import FusionDataset
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.datasets.photo_dataset import (
        PhotoEventsDataset, compute_photo_feature_stats,
    )
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.fusion import AppleCiderTask
    from applecider_tpu_torch.models.mpt import MPTTask, warmstart_classifier_params
    from applecider_tpu_torch.ops.metrics import classification_report, confusion_matrix
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import BTS_CLASS_WEIGHTS, make_corpus
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime
    from applecider_tpu_torch.train.trainer import Trainer

    data_dir, labels_csv = make_corpus(root, n_objects=n_objects, seed=seed, learnable=True,
                                       class_weights=BTS_CLASS_WEIGHTS, n_photometry=50,
                                       n_alerts=4)
    out = root / "out"
    preprocess_data(str(data_dir), str(labels_csv), str(out), min_per_class=3, seed=42)
    compute_photo_feature_stats(out / "manifest_train.csv", 100.0, out / "photo_stats.npz")

    # ---------------------------------------------------------- photometry
    overrides = {
        "model": {"name": "BaselineCLS", "BaselineCLS": {
            "d_model": 32, "n_heads": 4, "n_layers": 2, "dropout": 0.1,
            "lr": 1e-3, "pretrain_lr": 1e-3}},
        # no EMA on the photometry path (the reference recipe has none); the
        # fusion stage below runs EMA
        "train": {"epochs": epochs, "compute_dtype": "float32", "seed": seed,
                  "plateau_factor": 0.5, "plateau_patience": 4, "early_stop_patience": 10},
        "data_loader": {"batch_size": 16},
        "checkpoint": {"resume": False},
        "model_inputs": {p: {"data": {"dataset_class": "PhotoEventsDataset"}}
                         for p in ("train", "validate", "infer")},
    }
    rt = AppleCiderRuntime(overrides=overrides, workdir=root / "results", device=device)
    sec = f'data_set."{PhotoEventsDataset.SECTION}"'
    rt.set_config(f"{sec}.manifest_path", str(out / "manifest_train.csv"))
    rt.set_config(f"{sec}.stats_path", str(out / "photo_stats.npz"))
    rt.set_config(f"{sec}.use_oversampling", True)
    rt.prepare()
    train_ds = rt.datasets["train"]

    def photo_split(name):
        cfg = rt.config.merged_with({})
        cfg.set(f"{sec}.manifest_path", str(out / f"manifest_{name}.csv"))
        cfg.set(f"{sec}.use_oversampling", False)
        return PhotoEventsDataset(cfg)

    val_ds, test_ds = photo_split("val"), photo_split("test")
    test_labels = np.asarray([test_ds.sample(i)["label"] for i in range(len(test_ds))])

    # 1. MPT pretraining
    mpt = MPTTask(rt.config, device=device, generator=torch.Generator().manual_seed(seed))
    pre = Trainer(mpt, rt.config, root / "results" / "pretrain", device=device).fit(
        DataLoader(train_ds, batch_size=16, seed=seed),
        epochs=max(8, epochs // 2) if mpt_epochs is None else mpt_epochs)
    mpt_losses = [h["train_loss"] for h in pre["history"]]

    # 2. warm-started fine-tune beside a cold one
    def finetune(tag, init_params=None):
        task = rt._task()
        tr = Trainer(task, rt.config, root / "results" / tag, device=device)
        res = tr.fit(DataLoader(train_ds, batch_size=16, seed=seed),
                     DataLoader(val_ds, batch_size=16, shuffle=False), init_params=init_params)
        probs = tr.predict(DataLoader(test_ds, batch_size=16, shuffle=False))
        return res, _numbers(classification_report(probs, test_labels))

    warm = warmstart_classifier_params(rt._task().module.state_dict(), mpt.module.state_dict())
    res_warm, test_warm = finetune("finetune_warm", init_params=warm)
    res_cold, test_cold = finetune("finetune_cold")

    # ------------------------------------------------------------- fusion
    cfg = load_defaults()
    for key, value in {
        "model.BaselineCLS.d_model": 32, "model.BaselineCLS.n_heads": 4,
        "model.BaselineCLS.n_layers": 1, "model.BaselineCLS.dropout": 0.1,
        "model.SpectraNet.channels": [8, 16], "model.SpectraNet.depths": [1, 1],
        "model.SpectraNet.kernel_sizes_per_stage": [[3, 7], [3, 5]],
        "model.AstroMiNN.backbone_depths": [1, 1], "model.AstroMiNN.backbone_dims": [8, 16],
        "model.AppleCider.fusion": "concat", "model.AppleCider.lr": 5e-4,
        "train.compute_dtype": "float32", "train.epochs": epochs, "train.seed": seed,
        "train.ema_decay": 0.98, "train.plateau_factor": 0.5, "train.plateau_patience": 4,
        "train.early_stop_patience": 10, "checkpoint.resume": False,
    }.items():
        cfg.set(key, value)
    fsec = f'data_set."{FusionDataset.SECTION}"'
    cfg.set(f"{fsec}.stats_event_path", str(out / "photo_stats.npz"))
    cfg.set(f"{fsec}.max_len", 64)

    def fusion_split(name, oversample):
        c = cfg.merged_with({})
        c.set(f"{fsec}.manifest_path", str(out / f"manifest_{name}.csv"))
        c.set(f"{fsec}.use_oversampling", oversample)
        return FusionDataset(c, mode="per_object")

    ftrain, fval, ftest = (fusion_split("train", True), fusion_split("val", False),
                           fusion_split("test", False))
    model = build_fusion_model(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    ftr = Trainer(AppleCiderTask(cfg, model), cfg, root / "results" / "fusion", device=device)
    fres = ftr.fit(DataLoader(ftrain, batch_size=16, seed=seed),
                   DataLoader(fval, batch_size=16, shuffle=False))
    fprobs = ftr.predict(DataLoader(ftest, batch_size=16, shuffle=False))
    flabels = np.asarray([ftest.sample(i)["label"] for i in range(len(ftest))])
    majority = float(np.bincount(flabels, minlength=5).max()) / max(len(flabels), 1)
    return {
        "seed": seed,
        "n_objects": n_objects,
        "mpt_losses": [round(v, 4) for v in mpt_losses],
        "photo_warm_test": test_warm,
        "photo_cold_test": test_cold,
        "photo_warm_val_acc": res_warm["best_metric"],
        "photo_cold_val_acc": res_cold["best_metric"],
        "fusion_val_best_acc": fres["best_metric"],
        "fusion_test": _numbers(classification_report(fprobs, flabels)),
        "fusion_confusion": confusion_matrix(fprobs.argmax(-1), flabels, 5).tolist(),
        "fusion_history": [{k: round(float(v), 4) for k, v in h.items()
                            if isinstance(v, (int, float))} for h in fres["history"]],
        "test_majority_fraction": majority,
        "chance_accuracy": CHANCE,
    }


def _dig(d, path: str):
    for p in path.split("."):
        d = d.get(p) if isinstance(d, dict) else None
        if d is None:
            return None
    return d


def plot_confusion(outdir: Path) -> Path:
    """``confusion_fusion.png`` of seed 0's fusion test set, from the
    confusion counts in ``outdir/summary.json`` (``utils/plots.py``, which
    needs matplotlib)."""
    from applecider_tpu_torch.testing import CLASS_NAMES
    from applecider_tpu_torch.utils.plots import plot_confusion_matrix

    cm = np.asarray(json.loads((Path(outdir) / "summary.json").read_text())
                    ["per_seed"][0]["fusion_confusion"])
    labels, preds = np.nonzero(cm)  # one (label, prediction) pair a count
    counts = cm[labels, preds]
    path = Path(outdir) / "confusion_fusion.png"
    plot_confusion_matrix(np.repeat(preds, counts), np.repeat(labels, counts), CLASS_NAMES,
                          save_path=path)
    return path


def run(outdir: Path, seeds: int = 3, n_objects: int = 220, epochs: int = 25, device="cuda",
        quick: bool = False, mpt_epochs: int | None = None, log=print) -> dict:
    """Every seed of the protocol; writes the artifacts into ``outdir`` and
    returns the summary. Where matplotlib is not installed (the card's
    machine) the figure is left to ``--plot-only`` elsewhere."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    results = []
    for seed in range(seeds):
        root = Path(tempfile.mkdtemp(prefix=f"learn_s{seed}_"))
        t0 = time.perf_counter()
        try:
            r = run_seed(root, seed, n_objects, epochs, device, mpt_epochs)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        r["seconds"] = round(time.perf_counter() - t0, 2)
        (outdir / f"metrics_seed{seed}.jsonl").write_text(
            "\n".join(json.dumps(h) for h in r["fusion_history"]) + "\n")
        results.append(r)
        log(f"[seed {seed}] photo warm acc={r['photo_warm_test'].get('accuracy'):.3f} "
            f"cold acc={r['photo_cold_test'].get('accuracy'):.3f} "
            f"fusion acc={r['fusion_test'].get('accuracy'):.3f} "
            f"(majority {r['test_majority_fraction']:.3f}, chance {CHANCE}) in {r['seconds']} s")

    def agg(path):
        vals = [v for v in (_dig(x, path) for x in results) if v is not None]
        return {"mean": round(float(np.mean(vals)), 4), "std": round(float(np.std(vals)), 4),
                "n": len(vals)}

    summary = {
        "protocol": PROTOCOL,
        "seeds": seeds,
        "quick": quick,
        "n_objects": n_objects,
        "epochs": epochs,
        "device": str(device),
        "photo_warm_accuracy": agg("photo_warm_test.accuracy"),
        "photo_cold_accuracy": agg("photo_cold_test.accuracy"),
        "photo_warm_macro_f1": agg("photo_warm_test.macro_f1"),
        "fusion_accuracy": agg("fusion_test.accuracy"),
        "fusion_macro_f1": agg("fusion_test.macro_f1"),
        "chance_accuracy": CHANCE,
        "majority_fraction": agg("test_majority_fraction"),
        "seconds_per_seed": [r["seconds"] for r in results],
        "per_seed": results,
    }
    (outdir / "summary.json").write_text(json.dumps(summary, indent=1))
    try:
        plot_confusion(outdir)
    except ModuleNotFoundError as e:
        log(f"confusion_fusion.png not written ({e}); run --plot-only --outdir {outdir} "
            "where matplotlib is installed")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", default="results/h100/learning_demo")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--plot-only", action="store_true",
                    help="write confusion_fusion.png from --outdir's summary.json and stop")
    args = ap.parse_args(argv)
    if args.plot_only:
        print(plot_confusion(Path(args.outdir)))
        return
    if args.device != "cpu":
        from applecider_tpu_torch.device import card_name_and_power, resolve_device

        resolve_device(args.device)  # no card: raise before any work
        print(f"card: {card_name_and_power()}", flush=True)
    summary = run(Path(args.outdir), args.seeds, 80 if args.quick else 220,
                  8 if args.quick else 25, args.device, quick=args.quick,
                  log=lambda m: print(m, flush=True))
    print(json.dumps({k: v for k, v in summary.items() if k != "per_seed"}), flush=True)


if __name__ == "__main__":
    main()
