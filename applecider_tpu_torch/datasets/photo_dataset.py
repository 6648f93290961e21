"""Photometry event sequences (counterpart of the pieces of
``applecider_tpu/datasets/photo_dataset.py`` that the fusion dataset and
the preprocessing use):

* the coarse 5-class taxonomy keyed by class name (SN I / SN II / CV /
  AGN / TDE);
* ``load_event_sequence`` and ``build_photo_features``: a horizon cut on
  the raw dt (days), then the (L, 7) feature rows [log1p dt, log1p dt_prev,
  logf, logfe, one-hot band];
* ``collate_photometry``: pad to max(257, longest), truncate to 257, with
  a boolean pad mask (True = padding);
* the train-set stats of the four transformed channels, written by
  ``compute_photo_feature_stats`` and read by ``load_photo_stats``.

Manifests are read with ``preprocessing.table`` (no pandas).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.preprocessing.table import read_csv

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
