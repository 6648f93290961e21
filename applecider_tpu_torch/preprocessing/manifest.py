"""Manifests, train-feature statistics and stratified splits (counterpart of
``applecider_tpu/preprocessing/manifest.py``), with neither pandas nor
scikit-learn:

* ``built_all.csv`` and the per-split manifests, (object_id, filepath,
  label, label_str, n_events [, has_spectrum, spectrum_dt]), written as
  ``pandas.DataFrame.to_csv`` writes them (``table.write_csv``);
* streaming NaN-aware mean/std over the event or meta matrices of the npz
  files, summed in float64 in manifest order -> ``feature_stats_{event,
  meta}.npz``;
* splits: classes with fewer than ``min_per_class`` objects dropped, then
  70/15/15 stratified. ``train_test_split`` reproduces scikit-learn's
  ``train_test_split`` (``StratifiedShuffleSplit`` / ``ShuffleSplit`` on a
  ``np.random.RandomState``) id for id, its ``ValueError`` cases included,
  so the port splits a corpus as the JAX package does.
"""

from __future__ import annotations

import os
from math import floor
from pathlib import Path

import numpy as np

from applecider_tpu_torch.preprocessing.table import Table, read_csv, write_csv

MANIFEST_COLUMNS = ["object_id", "filepath", "label", "label_str", "n_events"]


def safe_manifest(rows) -> Table:
    """Records as a manifest table, ``MANIFEST_COLUMNS`` first."""
    if not len(rows):
        return Table({c: np.empty(0, object) for c in MANIFEST_COLUMNS})
    return Table.from_records(list(rows), MANIFEST_COLUMNS)


def write_manifest_csv(rows, path: Path, name: str = "") -> Table:
    df = safe_manifest(rows)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    write_csv(df, path)
    print(f"Wrote {name or path.name} -> {path} (rows={len(df)})")
    return df


def compute_feature_stats(manifest_csv: Path, kind: str, out_dir: Path) -> bool:
    """Streaming per-column mean/std over the ``{event,meta}_data`` matrices."""
    manifest_csv = Path(manifest_csv)
    if not manifest_csv.exists() or os.path.getsize(manifest_csv) == 0:
        print(f"[stats:{kind}] skip -> missing or empty: {manifest_csv}")
        return False
    manifest = read_csv(manifest_csv)
    if "filepath" not in manifest or len(manifest) == 0:
        print(f"[stats:{kind}] skip -> no rows")
        return False

    data_key = "event_data" if kind == "event" else "meta_data"
    cols_key = "event_columns" if kind == "event" else "meta_columns"
    total = sum_ = sumsq = columns = None
    for path in manifest["filepath"]:
        if not Path(path).exists():
            continue
        with np.load(path, allow_pickle=True) as npz:
            data = npz[data_key].astype(np.float64)
            if data.size == 0:
                continue
            if columns is None:
                columns = npz[cols_key]
        finite = np.isfinite(data)
        data = np.where(finite, data, 0.0)
        if sum_ is None:
            sum_ = data.sum(axis=0)
            sumsq = (data**2).sum(axis=0)
            total = finite.sum(axis=0).astype(np.float64)
        else:
            sum_ += data.sum(axis=0)
            sumsq += (data**2).sum(axis=0)
            total += finite.sum(axis=0)
    if total is None or (total == 0).all():
        print(f"[stats:{kind}] skip -> no data rows")
        return False
    denom = np.maximum(total, 1.0)
    mean = sum_ / denom
    var = sumsq / denom - mean**2
    std = np.sqrt(np.clip(var, 0, None))
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez(out_dir / f"feature_stats_{kind}.npz", columns=np.asarray(columns),
             mean=mean.astype(np.float32), std=std.astype(np.float32),
             count=total.astype(np.int64))
    print(f"[stats:{kind}] wrote {out_dir / f'feature_stats_{kind}.npz'}")
    return True


def find_available_ids(spec_csv: Path, data_dir: Path, id_cols=("object_id", "obj_id")) -> Table:
    """Rows of the label csv whose raw object dirs exist locally, in file
    order, the id column named ``object_id``."""
    spec = read_csv(spec_csv)
    id_col = next((c for c in id_cols if c in spec), None)
    if id_col is None:
        raise ValueError(f"no id column among {id_cols}; have {list(spec.columns)}")
    spec = Table({("object_id" if k == id_col else k): v for k, v in spec.data.items()})
    data_dir = Path(data_dir)
    have = {
        oid for oid in set(spec["object_id"])
        if (data_dir / str(oid) / "photometry.csv").exists()
        and (data_dir / str(oid) / "alerts.npy").exists()
    }
    return spec.take(np.asarray([oid in have for oid in spec["object_id"]], bool))


# ---------------------------------------------------------------- splits
def _validate_shuffle_split(n_samples: int, test_size, train_size) -> tuple[int, int]:
    """scikit-learn's ``_validate_shuffle_split`` for the sizes used here:
    a float ``train_size`` with no ``test_size``, or two integers."""
    for what, size in (("test_size", test_size), ("train_size", train_size)):
        if isinstance(size, int) and (size >= n_samples or size <= 0) or \
                isinstance(size, float) and (size <= 0 or size >= 1):
            raise ValueError(f"{what}={size} should be either positive and smaller than the "
                             f"number of samples {n_samples} or a float in the (0, 1) range")
    n_train = floor(train_size * n_samples) if isinstance(train_size, float) else train_size
    n_test = n_samples - n_train if test_size is None else test_size
    if n_train + n_test > n_samples:
        raise ValueError(f"The sum of train_size and test_size = {n_train + n_test}, should be "
                         f"smaller than the number of samples {n_samples}")
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty")
    return int(n_train), int(n_test)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """scikit-learn's ``_approximate_mode``: per-class draws, ties in the
    remainders broken by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_indices(y: np.ndarray, n_train: int, n_test: int, rng):
    """One split of scikit-learn's ``StratifiedShuffleSplit``."""
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    n_classes = classes.shape[0]
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too few: "
                         f"{classes[class_counts < 2].tolist()}")
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the number "
                         f"of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the number "
                         f"of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        perm = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(perm[: n_i[i]])
        test.extend(perm[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(a: np.ndarray, train_size: float, stratify=None, random_state: int = 0):
    """``sklearn.model_selection.train_test_split(a, train_size=...,
    stratify=..., random_state=...)``: the same (train, test) for the same
    arguments, and a ``ValueError`` where it raises one."""
    a = np.asarray(a)
    n_train, n_test = _validate_shuffle_split(len(a), None, train_size)
    n_train, n_test = _validate_shuffle_split(len(a), n_test, n_train)
    rng = np.random.RandomState(random_state)
    if stratify is None:
        perm = rng.permutation(len(a))
        train, test = perm[n_test: n_test + n_train], perm[:n_test]
    else:
        y = np.asarray(stratify)
        if len(y) != len(a):
            raise ValueError(f"Found input variables with inconsistent numbers of samples: "
                             f"[{len(a)}, {len(y)}]")
        train, test = _stratified_indices(y, n_train, n_test, rng)
    return a[train], a[test]


def _value_counts(values) -> dict:
    counts: dict = {}
    for v in values:
        if not (isinstance(v, float) and np.isnan(v)):
            counts[v] = counts.get(v, 0) + 1
    return counts


def make_splits_from_manifest(
    built_csv: Path,
    out_root: Path,
    *,
    min_per_class: int = 7,
    train_frac: float = 0.70,
    val_frac: float = 0.15,
    test_frac: float = 0.15,
    seed: int = 42,
    strict_stratify: bool = True,
) -> Table:
    """Filter under-represented classes, stratify 70/15/15, write
    ``splits.csv``, the three manifests and the train-only stats."""
    out_root = Path(out_root)
    built = read_csv(built_csv)
    if len(built) == 0:
        raise RuntimeError(f"no rows in {built_csv}")
    if "label_str" not in built:
        raise RuntimeError("manifest must contain label_str")

    counts = _value_counts(built["label_str"])
    keep_classes = {c for c, n in counts.items() if n >= min_per_class}
    filtered = built.take(np.asarray([v in keep_classes for v in built["label_str"]], bool))
    n_all, n_kept = len(set(built["object_id"])), len(set(filtered["object_id"]))
    print(f"Keeping {len(keep_classes)} classes with >= {min_per_class} examples -> "
          f"{n_kept} objects (dropped {n_all - n_kept}).")
    if len(filtered) == 0:
        raise RuntimeError("nothing left after min_per_class filtering")

    ids = filtered["object_id"]
    labels = filtered["label_str"]
    row_of = {oid: i for i, oid in enumerate(ids)}
    if len(row_of) != len(ids):
        raise ValueError(f"{built_csv} lists an object_id more than once")
    kept_counts = _value_counts(labels)
    can_stratify = min(kept_counts.values()) >= 2 and len(kept_counts) >= 2
    if can_stratify:
        try:
            tr, rest = train_test_split(ids, train_size=train_frac, stratify=labels,
                                        random_state=seed)
        except ValueError:
            # corpus too small for the class count: seeded random split
            can_stratify = False
            strict_stratify = False
    if can_stratify:
        rest_labels = labels[[row_of[oid] for oid in rest]]
        remainder = 1.0 - train_frac
        val_share = val_frac / remainder
        if not np.isclose(val_share + test_frac / remainder, 1.0):
            val_share = 0.5
        try:
            va, te = train_test_split(rest, train_size=val_share, stratify=rest_labels,
                                      random_state=seed)
        except ValueError:
            # remainder too small to stratify: seeded random val/test split
            va, te = train_test_split(rest, train_size=val_share, random_state=seed)
    else:
        if strict_stratify:
            raise ValueError(
                "stratified split infeasible; lower min_per_class or set strict_stratify=False")
        rng = np.random.RandomState(seed)
        shuffled = ids.copy()
        rng.shuffle(shuffled)
        n_tr = int(round(train_frac * len(shuffled)))
        remainder = 1.0 - train_frac
        n_va = int(round((val_frac / remainder) * (len(shuffled) - n_tr))) if remainder > 0 else 0
        tr = shuffled[:n_tr]
        va = shuffled[n_tr: n_tr + n_va]
        te = shuffled[n_tr + n_va:]

    splits = Table.from_records(
        [{"object_id": oid, "split": split, "label_str": labels[row_of[oid]]}
         for part, split in ((tr, "train"), (va, "val"), (te, "test")) for oid in part])
    out_root.mkdir(parents=True, exist_ok=True)
    write_csv(splits, out_root / "splits.csv")
    print(f"Wrote splits -> {out_root / 'splits.csv'}")

    for split in ("train", "val", "test"):
        rows_ = [
            {
                "object_id": oid,
                "filepath": filtered["filepath"][row_of[oid]],
                "label": int(filtered["label"][row_of[oid]]),
                "label_str": labels[row_of[oid]],
                "n_events": int(filtered["n_events"][row_of[oid]]),
            }
            for oid, s in zip(splits["object_id"], splits["split"]) if s == split
        ]
        write_manifest_csv(rows_, out_root / f"manifest_{split}.csv", name=f"manifest_{split}.csv")

    train_manifest = out_root / "manifest_train.csv"
    if train_manifest.exists() and os.path.getsize(train_manifest) > 0:
        compute_feature_stats(train_manifest, "event", out_root)
        compute_feature_stats(train_manifest, "meta", out_root)
    print("Splitting complete.")
    return splits
