"""Hyperparameter sweep of the PyTorch port (optuna-compatible, gated).

The port's copy of ``sweep.py``: the reference drives sweeps with optuna;
where optuna is not installed the example runs a seeded random search over
the same space, and ``objective(trial, root, device)`` takes an optuna
``Trial`` unchanged. Through ``applecider_tpu_torch`` alone; runs on the
GPU unless the CPU is asked for:

    python docs/examples/torch_sweep.py /tmp/ac_sweep [--device cpu] [--trials 3]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


class RandomTrial:
    """The part of ``optuna.Trial`` the objective uses, drawing at random."""

    def __init__(self, rng):
        self.rng = rng
        self.params = {}

    def suggest_float(self, name, low, high, log=False):
        import numpy as np

        v = float(np.exp(self.rng.uniform(np.log(low), np.log(high))) if log
                  else self.rng.uniform(low, high))
        self.params[name] = v
        return v

    def suggest_categorical(self, name, choices):
        v = choices[int(self.rng.integers(len(choices)))]
        self.params[name] = v
        return v


def objective(trial, root: Path, device: str = "cuda") -> float:
    from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset
    from applecider_tpu_torch.train import AppleCiderRuntime

    lr = trial.suggest_float("lr", 1e-5, 1e-3, log=True)
    dropout = trial.suggest_float("dropout", 0.0, 0.5)
    d_model = trial.suggest_categorical("d_model", [16, 32])
    overrides = {
        "model": {"name": "BaselineCLS", "BaselineCLS": {
            "d_model": d_model, "n_heads": 4, "n_layers": 1, "dropout": dropout, "lr": lr}},
        "train": {"epochs": 2, "compute_dtype": "float32"},
        "data_loader": {"batch_size": 8},
        "model_inputs": {p: {"data": {"dataset_class": "PhotoEventsDataset"}}
                         for p in ("train", "validate")},
    }
    rt = AppleCiderRuntime(overrides=overrides, workdir=root / "sweep_results", device=device)
    sec = f'data_set."{PhotoEventsDataset.SECTION}"'
    rt.set_config(f"{sec}.manifest_path", str(root / "out" / "manifest_train.csv"))
    rt.set_config(f"{sec}.use_oversampling", False)
    return rt.train()["history"][-1].get("val_accuracy", 0.0)


def main(root: Path, device: str = "cuda", n_trials: int = 3) -> tuple:
    import numpy as np

    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus

    root.mkdir(parents=True, exist_ok=True)
    data_dir, labels_csv = make_corpus(root, n_objects=15, seed=3)
    preprocess_data(str(data_dir), str(labels_csv), str(root / "out"), min_per_class=1)
    try:
        import optuna
    except ImportError:
        optuna = None
    if optuna is not None:
        study = optuna.create_study(direction="maximize")
        study.optimize(lambda t: objective(t, root, device), n_trials=n_trials)
        print("best:", study.best_params, study.best_value)
        return study.best_value, study.best_params
    rng = np.random.default_rng(0)
    best = (-1.0, None)
    for i in range(n_trials):
        trial = RandomTrial(rng)
        score = objective(trial, root, device)
        print(f"trial {i}: {trial.params} -> {score:.3f}")
        if score > best[0]:
            best = (score, trial.params)
    print("best:", best[1], best[0])
    return best


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args()
    main(Path(args.root) if args.root else Path(tempfile.mkdtemp()), args.device, args.trials)
