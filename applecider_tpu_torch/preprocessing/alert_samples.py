"""Per-alert samples of the image+metadata (AstroMiNN) path (counterpart of
``applecider_tpu/preprocessing/alert_samples.py``).

``metadata24_from_npz``: the 24-column AstroMiNN metadata of a multimodal
npz: columns 0..18 are ``ALERT_META_KEEP[:19]`` (sgscore1..rb, ra/dec
pre-scaled) and columns 19..23 the light-curve context block
[days_since_peak, days_to_peak, peakmag_so_far, maxmag_so_far,
n_photometry_total].

``build_alert_samples``: each alert of each manifest object as a ``.npy``
sample dict {obj_id, image (3, H, W), metadata (24,), target}, and an
index ``alert_samples.csv``; the files are byte for byte the JAX
package's, and the manifest is read with ``preprocessing.table`` (no
pandas).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.preprocessing.table import Table, read_csv, write_csv

ALERT_META_24_CONTEXT = (
    "days_since_peak", "days_to_peak", "peakmag_so_far", "maxmag_so_far", "n_photometry_total",
)


def metadata24_from_npz(meta_data: np.ndarray, meta_columns) -> np.ndarray:
    """(T, 46) multimodal meta matrix -> (T, 24) AstroMiNN metadata."""
    cols = {c: i for i, c in enumerate(meta_columns)}
    first19 = meta_data[:, :19]
    ctx = np.stack([meta_data[:, cols[c]] for c in ALERT_META_24_CONTEXT], axis=1)
    return np.concatenate([first19, ctx], axis=1).astype(np.float32)


def build_alert_samples(manifest_csv: str | Path, out_dir: str | Path, max_per_object: int = 0,
                        seed: int = 42) -> Table:
    """Write ``<out_dir>/<object_id>_alert<t:03d>.npy`` for every alert t of
    every object of the manifest (``object_id``, ``filepath`` of its
    multimodal npz) and ``alert_samples.csv`` (obj_id, alert_index,
    filepath); returns that index. ``max_per_object > 0`` keeps that many
    alerts of an object, drawn without replacement from one
    ``default_rng(seed)`` and kept in order."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest = read_csv(manifest_csv)
    rng = np.random.default_rng(seed)
    rows = []
    for object_id, filepath in zip(manifest["object_id"].tolist(),
                                   manifest["filepath"].tolist()):
        with np.load(filepath, allow_pickle=True) as npz:
            images = npz["images"]
            meta24 = metadata24_from_npz(npz["meta_data"], npz["meta_columns"])
            label_str = str(npz["label_str"])
        n = len(images)
        take = np.arange(n)
        if max_per_object and n > max_per_object:
            take = np.sort(rng.choice(n, size=max_per_object, replace=False))
        for t in take:
            sample = {"obj_id": object_id, "image": images[t], "metadata": meta24[t],
                      "target": label_str}
            path = out_dir / f"{object_id}_alert{t:03d}.npy"
            np.save(path, np.asarray(sample, dtype=object), allow_pickle=True)
            rows.append({"obj_id": object_id, "alert_index": int(t), "filepath": str(path)})
    index = Table.from_records(rows)
    write_csv(index, out_dir / "alert_samples.csv")
    return index
