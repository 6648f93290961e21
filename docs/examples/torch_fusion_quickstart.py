"""End-to-end 4-modality fusion training of the PyTorch port on a
synthetic corpus.

The port's copy of ``fusion_quickstart.py``: a raw ZTF-shaped corpus ->
preprocessed npz -> ``FusionDataset`` (per alert: photometry cut at each
alert's time) -> the AppleCider model at small widths -> ``Trainer.fit``
with validation -> per-alert probabilities through the serving pipeline
with the trained weights, through ``applecider_tpu_torch`` alone. Runs on
the GPU unless the CPU is asked for:

    python docs/examples/torch_fusion_quickstart.py /tmp/ac_fusion [--device cpu]
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

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.datasets.fusion_dataset import FusionDataset
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.infer.stream import AlertStreamPipeline, pack_alert_batch
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.fusion import AppleCiderTask
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus
    from applecider_tpu_torch.train import Trainer

    root.mkdir(parents=True, exist_ok=True)

    # 1. raw corpus -> npz + manifests + splits + train stats
    data_dir, labels_csv = make_corpus(root, n_objects=16, seed=3, n_photometry=24, n_alerts=3)
    out = root / "out"
    preprocess_data(str(data_dir), str(labels_csv), str(out), min_per_class=1)

    # 2. a small fusion config (the whole architecture, narrow widths)
    cfg = load_defaults()
    for key, value in {
        "model.BaselineCLS.d_model": 16, "model.BaselineCLS.n_heads": 2,
        "model.BaselineCLS.n_layers": 1, "model.BaselineCLS.dropout": 0.0,
        "model.SpectraNet.channels": [4, 8], "model.SpectraNet.depths": [1, 1],
        "model.SpectraNet.kernel_sizes_per_stage": [[3, 7], [3, 5]],
        "model.AstroMiNN.backbone_depths": [1, 1], "model.AstroMiNN.backbone_dims": [8, 16],
        "model.AppleCider.fusion": "concat",
        "train.compute_dtype": "float32", "train.epochs": 2, "checkpoint.resume": False,
    }.items():
        cfg.set(key, value)
    sec = f'data_set."{FusionDataset.SECTION}"'
    cfg.set(f"{sec}.manifest_path", str(out / "manifest_train.csv"))
    # photo_stats.npz: the statistics of the transformed channels (written by
    # preprocess_data), not the raw per-column feature_stats_event.npz
    cfg.set(f"{sec}.stats_event_path", str(out / "photo_stats.npz"))
    cfg.set(f"{sec}.max_len", 64)

    # 3. per-alert fusion data set + trainer
    train_ds = FusionDataset(cfg, mode="per_alert")
    cfg_val = cfg.merged_with({})
    cfg_val.set(f"{sec}.manifest_path", str(out / "manifest_val.csv"))
    val_ds = FusionDataset(cfg_val, mode="per_alert")
    model = build_fusion_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(AppleCiderTask(cfg, model), cfg, root / "results", device=device)
    results = trainer.fit(DataLoader(train_ds, batch_size=8, seed=0),
                          DataLoader(val_ds, batch_size=8, seed=0))
    last = results["history"][-1]
    print("train loss:", [round(h["train_loss"], 3) for h in results["history"]])
    print("val:", {k: round(v, 3) for k, v in last.items() if k.startswith("val_")})

    # 4. per-alert streaming inference with the trained weights
    pipe = AlertStreamPipeline(model.eval(), stats_mean=train_ds.mean, stats_std=train_ds.std,
                               wave_grid=np.linspace(4500.0, 7980.0, 3481, dtype=np.float32),
                               device=device)
    rng = np.random.default_rng(0)
    raw_alerts = []
    for _ in range(4):
        P = int(rng.integers(10, 20))
        raw_alerts.append({
            "photo_t": np.sort(rng.uniform(0, 40, P)).astype(np.float32),
            "photo_flux": rng.lognormal(2.0, 1.0, P).astype(np.float32),
            "photo_err": rng.uniform(0.5, 2.0, P).astype(np.float32),
            "photo_band": rng.integers(0, 3, P).astype(np.int32),
            "image": rng.normal(size=(63, 63, 3)).astype(np.float32),
            "meta19": rng.normal(size=19).astype(np.float32),
        })
    raw = {k: torch.from_numpy(v).to(pipe.device)
           for k, v in pack_alert_batch(raw_alerts, max_photo=64).items()}
    probs = pipe(raw).cpu().numpy()
    assert probs.shape == (4, 5) and np.allclose(probs.sum(-1), 1.0, atol=1e-4)
    print("stream per-alert probabilities:", np.round(probs[0], 3))
    return {"history": results["history"], "probs": probs}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(Path(args.root) if args.root else Path(tempfile.mkdtemp()), args.device)
