"""Preprocessing CLI (counterpart of ``applecider_tpu/preprocessing/cli.py``):
build the multimodal corpus, make the stratified splits, compute the train
stats and the photometry normalisation stats.

    applecider-preprocess-torch --raw_path raw/ --spec_path labels.csv --output_path out/
"""

from __future__ import annotations

import argparse
from pathlib import Path

from applecider_tpu_torch.datasets.photo_dataset import compute_photo_feature_stats
from applecider_tpu_torch.preprocessing.builder import build_all_preprocessed
from applecider_tpu_torch.preprocessing.config import PreprocessConfig
from applecider_tpu_torch.preprocessing.manifest import make_splits_from_manifest


def preprocess_data(
    raw_path: str,
    spec_path: str,
    output_path: str,
    *,
    min_per_class: int = 7,
    seed: int = 42,
    num_workers: int = 0,
):
    cfg = PreprocessConfig(
        data_dir=Path(raw_path),
        spec_csv=Path(spec_path),
        output_root=Path(output_path),
        random_seed=seed,
        num_workers=num_workers,
    )
    build_all_preprocessed(cfg)
    make_splits_from_manifest(Path(output_path) / "built_all.csv", Path(output_path),
                              min_per_class=min_per_class, seed=seed)
    # model-ready stats of the TRANSFORMED photometry channels (the
    # feature_stats_event.npz written above is raw per-column stats, which
    # load_photo_stats refuses)
    train_manifest = Path(output_path) / "manifest_train.csv"
    if train_manifest.exists():
        compute_photo_feature_stats(train_manifest, 100.0, Path(output_path) / "photo_stats.npz")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build the multimodal training corpus.")
    parser.add_argument("--raw_path", required=True, help="directory of per-object raw dirs")
    parser.add_argument("--spec_path", required=True, help="labels csv (object_id,type)")
    parser.add_argument("--output_path", required=True, help="output root for npz + manifests")
    parser.add_argument("--min_per_class", type=int, default=7)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_workers", type=int, default=0)
    args = parser.parse_args(argv)
    preprocess_data(args.raw_path, args.spec_path, args.output_path,
                    min_per_class=args.min_per_class, seed=args.seed,
                    num_workers=args.num_workers)


if __name__ == "__main__":
    main()
