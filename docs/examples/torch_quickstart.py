"""End-to-end quickstart of the PyTorch port on a synthetic corpus.

The port's copy of ``quickstart.py`` (the reference's pre-executed example:
prepare -> MPT pretrain -> weight surgery -> finetune -> infer -> export),
through ``applecider_tpu_torch`` alone. Runs on the GPU unless the CPU is
asked for:

    python docs/examples/torch_quickstart.py /tmp/ac_quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(root: Path, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.datasets.photo_dataset import (
        PhotoEventsDataset, compute_photo_feature_stats,
    )
    from applecider_tpu_torch.models.mpt import MPTTask, warmstart_classifier_params
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus
    from applecider_tpu_torch.train import AppleCiderRuntime, Trainer

    root.mkdir(parents=True, exist_ok=True)

    # 1. synthesize a raw corpus and preprocess it
    data_dir, labels_csv = make_corpus(root, n_objects=20, seed=7)
    out = root / "out"
    preprocess_data(str(data_dir), str(labels_csv), str(out), min_per_class=1)
    compute_photo_feature_stats(out / "manifest_train.csv", 100.0, out / "photo_stats.npz")

    # 2. configure a small photometry run
    overrides = {
        "model": {"name": "BaselineCLS", "BaselineCLS": {
            "d_model": 32, "n_heads": 4, "n_layers": 1, "dropout": 0.1}},
        "train": {"epochs": 3, "compute_dtype": "float32"},
        "data_loader": {"batch_size": 8},
        "model_inputs": {p: {"data": {"dataset_class": "PhotoEventsDataset"}}
                         for p in ("train", "validate", "infer")},
    }
    rt = AppleCiderRuntime(overrides=overrides, workdir=root / "results", device=device)
    sec = f'data_set."{PhotoEventsDataset.SECTION}"'
    rt.set_config(f"{sec}.manifest_path", str(out / "manifest_train.csv"))
    rt.set_config(f"{sec}.stats_path", str(out / "photo_stats.npz"))
    rt.set_config(f"{sec}.use_oversampling", True)
    rt.prepare()

    # 3. MPT self-supervised pretraining + weight surgery
    mpt = MPTTask(rt.config, device=device, generator=torch.Generator().manual_seed(0))
    loader = DataLoader(rt.datasets["train"], batch_size=8, seed=0)
    pre = Trainer(mpt, rt.config, root / "results" / "pretrain", device=device).fit(loader, epochs=2)
    print("pretrain history:", [round(h["train_loss"], 3) for h in pre["history"]])
    warm = warmstart_classifier_params(rt._task().module.state_dict(), mpt.module.state_dict())
    print("warm-start trunk copied:",
          torch.equal(warm["trunk.in_proj.weight"], mpt.module.state_dict()["trunk.in_proj.weight"]))

    # 4. supervised finetune (warm-started), then inference and export
    results = rt.train(init_params=warm)
    print("train history:", [round(h["train_loss"], 3) for h in results["history"]])
    # the reference recipe flips use_probabilities before infer
    rt.config.set("model.BaselineCLS.use_probabilities", True)
    probs = rt.infer()
    row_sum = float(np.asarray(probs).sum(axis=-1).mean())
    assert abs(row_sum - 1.0) < 1e-4, f"probability rows must sum to 1, got {row_sum}"
    print("inference:", probs.shape, "prob rows sum to", row_sum)
    export_dir = rt.export()
    print("exported:", sorted(p.name for p in export_dir.iterdir()))
    return {"pretrain": pre["history"], "train": results["history"], "probs": probs,
            "export_dir": export_dir}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(Path(args.root) if args.root else Path(tempfile.mkdtemp()), args.device)
