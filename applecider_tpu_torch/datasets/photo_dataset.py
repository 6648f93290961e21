"""Photometry event sequences (counterpart of
``applecider_tpu/datasets/photo_dataset.py``):

* the coarse 5-class taxonomy keyed by class name (SN I / SN II / CV /
  AGN / TDE);
* ``load_event_sequence`` and ``build_photo_features``: a horizon cut on
  the raw dt (days), then the (L, 7) feature rows [log1p dt, log1p dt_prev,
  logf, logfe, one-hot band];
* ``collate_photometry``: pad to max(257, longest), truncate to 257, with
  a boolean pad mask (True = padding);
* the train-set stats of the four transformed channels, written by
  ``compute_photo_feature_stats`` and read by ``load_photo_stats``;
* ``PhotoEventsDataset``, the photometry-only dataset of the BaselineCLS
  classifier and its MPT pretraining: one sample per manifest row (sorted
  by ``object_id``), the horizon-cut (L, 7) features, the coarse label,
  the train stats, and optional oversampling toward an ideal class
  distribution. Its config section keeps the JAX package's name
  (``SECTION``), so one run TOML drives both packages.

Manifests are read with ``preprocessing.table`` (no pandas).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.datasets.oversampler import Oversampler
from applecider_tpu_torch.preprocessing.table import read_csv
from applecider_tpu_torch.registry import register_dataset

COARSE_CLASSES = ("SN I", "SN II", "Cataclysmic", "AGN", "Tidal Disruption Event")

TAXONOMY_BY_NAME = {
    "SN I": 0, "SN Ia": 0, "SN Ib": 0, "SN Ic": 0,
    "SN II": 1, "SN IIP": 1, "SN IIp": 1, "SN IIn": 1, "SN IIb": 1,
    "Cataclysmic": 2, "CV": 2,
    "AGN": 3,
    "Tidal Disruption Event": 4, "TDE": 4,
}

DEFAULT_MAX_LEN = 257


def load_event_sequence(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dt_days, features3 [dt_prev, logf, logfe], band) from either npz
    schema: the multimodal npz (``event_data`` + ``event_columns``) or the
    legacy photo_events npz (``data``: dt, dt_prev, band, logf, logfe)."""
    with np.load(path, allow_pickle=True) as npz:
        if "event_data" in npz.files:
            data = npz["event_data"]
            cols = {c: i for i, c in enumerate(npz["event_columns"])}
            dt = data[:, cols["dt"]]
            dt_prev = data[:, cols["dt_prev"]]
            band = data[:, cols["band_id"]]
            logf = data[:, cols["logflux"]]
            logfe = data[:, cols["logflux_err"]]
        else:
            data = npz["data"]
            dt, dt_prev, band, logf, logfe = (data[:, i] for i in range(5))
    return (
        np.asarray(dt, np.float32),
        np.stack([np.asarray(dt_prev, np.float32), np.asarray(logf, np.float32),
                  np.asarray(logfe, np.float32)], axis=1),
        np.asarray(band, np.float32),
    )


def build_photo_features(dt, rest, band, horizon: float) -> np.ndarray:
    """Horizon cut + feature transform -> (L, 7)."""
    keep = dt <= horizon
    dt = dt[keep]
    dt_prev, logf, logfe = rest[keep, 0], rest[keep, 1], rest[keep, 2]
    band = band[keep]
    vec4 = np.stack([np.log1p(dt), np.log1p(dt_prev), logf, logfe], axis=1)
    one_hot = np.eye(3, dtype=np.float32)[np.clip(band.astype(np.int64), 0, 2)]
    return np.concatenate([vec4, one_hot], axis=1).astype(np.float32)


def collate_photometry(samples: list[dict], max_len: int = DEFAULT_MAX_LEN) -> dict:
    """Pad to max(max_len, longest) then truncate to max_len, True = pad."""
    seqs = [s["photometry"] for s in samples]
    lengths = [len(s) for s in seqs]
    width = max([max_len, *lengths])
    batch = np.zeros((len(seqs), width, seqs[0].shape[1]), np.float32)
    mask = np.ones((len(seqs), width), bool)
    for i, (seq, n) in enumerate(zip(seqs, lengths)):
        batch[i, :n] = seq
        mask[i, :n] = False
    out = {
        "photometry": batch[:, :max_len],
        "pad_mask": mask[:, :max_len],
        "mean": np.asarray(samples[0]["mean"], np.float32),
        "std": np.asarray(samples[0]["std"], np.float32),
    }
    if "label" in samples[0]:
        out["label"] = np.asarray([s["label"] for s in samples], np.int64)
    return {"data": out}


@register_dataset(name="PhotoEventsDataset")
class PhotoEventsDataset:
    SECTION = "applecider_tpu.datasets.photo_dataset.PhotoEventsDataset"

    def __init__(self, config, data_location=None):
        section = config["data_set"][self.SECTION]
        manifest = read_csv(section.get("manifest_path") or data_location)
        self.manifest = manifest.take(np.argsort(manifest["object_id"], kind="stable"))
        self.horizon = float(section.get("horizon", 100.0))
        self.max_len = int(section.get("max_len", DEFAULT_MAX_LEN))
        stats_path = section.get("stats_path", "")
        if stats_path and Path(stats_path).exists():
            self.mean, self.std = load_photo_stats(stats_path)
        else:
            self.mean = np.zeros(4, np.float32)
            self.std = np.ones(4, np.float32)
        self.coarse_labels = np.asarray(
            [self._coarse_label(i) for i in range(len(self.manifest))], np.int64)
        self.oversampler = None
        if bool(section.get("use_oversampling", False)):
            self.oversampler = Oversampler(
                section.get("ideal_class_distribution", [0.3, 0.1, 0.1, 0.3, 0.1]),
                self.coarse_labels,
                seed=int(config.get_path("data_loader.seed", default=42)),
            )

    def _coarse_label(self, row: int) -> int:
        """The class name's coarse label, else ``label`` modulo the five
        classes, else 0."""
        if "label_str" in self.manifest:
            name = self.manifest["label_str"][row]
            if isinstance(name, str) and name in TAXONOMY_BY_NAME:
                return TAXONOMY_BY_NAME[name]
        label = self.manifest["label"][row] if "label" in self.manifest else 0
        return int(label) % len(COARSE_CLASSES)

    def __len__(self) -> int:
        return len(self.oversampler) if self.oversampler is not None else len(self.manifest)

    def _resolve(self, idx: int) -> int:
        if self.oversampler is not None:
            idx, _ = self.oversampler.resolve(idx)
        return idx

    def sample(self, idx: int) -> dict:
        row = self._resolve(idx)
        dt, rest, band = load_event_sequence(self.manifest["filepath"][row])
        return {"photometry": build_photo_features(dt, rest, band, self.horizon),
                "label": int(self.coarse_labels[row]), "mean": self.mean, "std": self.std}

    def collate(self, samples: list[dict]) -> dict:
        return collate_photometry(samples, max_len=self.max_len)


register_dataset(PhotoEventsDataset, name=PhotoEventsDataset.SECTION)


def load_photo_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) of the four transformed photometry channels from a
    ``compute_photo_feature_stats`` npz. Refuses the raw per-column layout
    (``feature_stats_event.npz``, which has a ``columns`` key): its first
    four columns are raw dt, raw dt_prev, band_id and logflux, not the
    channels the model normalises."""
    with np.load(path) as st:
        if "columns" in st.files:
            raise ValueError(
                f"{path} holds RAW per-column event stats "
                f"(columns={[str(c) for c in st['columns'][:5]]}...); the model normalizes the "
                "TRANSFORMED 4-channel features: build photo_stats.npz with "
                "datasets.photo_dataset.compute_photo_feature_stats")
        return st["mean"].astype(np.float32)[:4], st["std"].astype(np.float32)[:4]


def compute_photo_feature_stats(manifest_path: str | Path, horizon: float, out_path: str | Path):
    """Train-set mean/std over the four continuous photometry channels,
    summed in float64 in manifest order."""
    manifest = read_csv(manifest_path)
    total = 0
    s = np.zeros(4, np.float64)
    ss = np.zeros(4, np.float64)
    for path in manifest["filepath"]:
        dt, rest, band = load_event_sequence(path)
        feats = build_photo_features(dt, rest, band, horizon)[:, :4].astype(np.float64)
        s += feats.sum(axis=0)
        ss += (feats**2).sum(axis=0)
        total += len(feats)
    mean = s / max(total, 1)
    std = np.sqrt(np.clip(ss / max(total, 1) - mean**2, 0, None))
    np.savez(out_path, mean=mean.astype(np.float32), std=std.astype(np.float32))
    return mean.astype(np.float32), std.astype(np.float32)
