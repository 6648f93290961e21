"""Four-modality fusion dataset (counterpart of
``applecider_tpu/datasets/fusion_dataset.py``).

One sample is the photometry sequence cut at the sample's alert time, the
24-column metadata, the cutout triplet, the spectrum and the coarse 5-class
label, read out of the multimodal npz files that ``preprocess_data`` writes:
one per object (its latest alert, ``mode="per_object"``) or one per
(object, alert) (``mode="per_alert"``). The manifest is read with
``preprocessing.table`` (no pandas). The config section keeps the JAX
package's name (``SECTION``), so one run TOML drives both packages.
"""

from __future__ import annotations

import numpy as np

from applecider_tpu_torch.datasets.oversampler import Oversampler
from applecider_tpu_torch.datasets.photo_dataset import (
    DEFAULT_MAX_LEN, TAXONOMY_BY_NAME, collate_photometry, load_photo_stats,
)
from applecider_tpu_torch.preprocessing.alert_samples import metadata24_from_npz
from applecider_tpu_torch.preprocessing.table import read_csv
from applecider_tpu_torch.registry import register_dataset

SPECTRUM_BINS = 3481


@register_dataset(name="FusionDataset")
@register_dataset(name="CiDErDataset")
class FusionDataset:
    SECTION = "applecider_tpu.datasets.fusion_dataset.FusionDataset"

    def __init__(self, config, data_location=None, mode: str = "per_object"):
        section = config["data_set"][self.SECTION]
        manifest_path = section.get("manifest_path") or data_location
        self.manifest = read_csv(manifest_path)
        self.horizon = float(section.get("horizon", 100.0))
        self.max_len = int(section.get("max_len", DEFAULT_MAX_LEN))
        self.mode = mode

        stats_path = section.get("stats_event_path", "")
        self.mean = np.zeros(4, np.float32)
        self.std = np.ones(4, np.float32)
        if stats_path:
            self.mean, self.std = load_photo_stats(stats_path)

        # (manifest row, event index) pairs
        n_rows = len(self.manifest)
        n_events = (self.manifest["n_events"] if "n_events" in self.manifest
                    else np.ones(n_rows, np.int64))
        self._rows: list[tuple[int, int]] = []
        for mi in range(n_rows):
            n = int(n_events[mi])
            if self.mode == "per_alert":
                self._rows.extend((mi, t) for t in range(n))
            else:
                self._rows.append((mi, n - 1))

        label_str = self.manifest["label_str"]
        self.labels = np.asarray(
            [TAXONOMY_BY_NAME.get(str(label_str[mi]), 0) for mi, _ in self._rows], np.int64)

        self.oversampler = None
        if bool(section.get("use_oversampling", False)):
            self.oversampler = Oversampler(
                section.get("ideal_class_distribution", [0.3, 0.1, 0.1, 0.3, 0.1]),
                self.labels,
                seed=int(config.get_path("data_loader.seed", default=42)),
            )
        self._obj_cache_mi = None
        self._obj_cache: dict = {}

    def __len__(self) -> int:
        return len(self.oversampler) if self.oversampler is not None else len(self._rows)

    def _resolve(self, idx: int) -> tuple[int, int]:
        if self.oversampler is not None:
            idx, _ = self.oversampler.resolve(idx)
        return self._rows[idx]

    def _object_arrays(self, mi: int) -> dict:
        """Decoded per-object arrays, cached for the current object:
        ``per_alert`` mode draws T consecutive samples from one object, and
        without the cache each would decompress the whole npz again."""
        if self._obj_cache_mi == mi:
            return self._obj_cache
        with np.load(self.manifest["filepath"][mi], allow_pickle=True) as npz:
            spectrum = npz["spectrum"]
            if spectrum.shape[0] == 0:
                spectrum = np.zeros(SPECTRUM_BINS, np.float32)
            obj = {
                "event_data": npz["event_data"],
                "cols": {c: i for i, c in enumerate(npz["event_columns"])},
                "jd": npz["jd"],
                "metadata24": metadata24_from_npz(npz["meta_data"], npz["meta_columns"]),
                "images": npz["images"],
                "spectrum": spectrum,
                "label": TAXONOMY_BY_NAME.get(str(npz["label_str"]), 0),
            }
        self._obj_cache_mi = mi
        self._obj_cache = obj
        return obj

    def sample(self, idx: int) -> dict:
        mi, t = self._resolve(idx)
        obj = self._object_arrays(mi)
        event_data, cols, jd = obj["event_data"], obj["cols"], obj["jd"]
        keep = jd <= jd[t]
        dt = event_data[keep, cols["dt"]]
        horizon_keep = dt <= self.horizon
        dt = dt[horizon_keep]
        dt_prev = event_data[keep, cols["dt_prev"]][horizon_keep]
        logf = event_data[keep, cols["logflux"]][horizon_keep]
        logfe = event_data[keep, cols["logflux_err"]][horizon_keep]
        band = event_data[keep, cols["band_id"]][horizon_keep]
        vec4 = np.stack([np.log1p(dt), np.log1p(dt_prev), logf, logfe], axis=1)
        one_hot = np.eye(3, dtype=np.float32)[np.clip(band.astype(np.int64), 0, 2)]
        photometry = np.concatenate([vec4, one_hot], axis=1).astype(np.float32)
        return {
            "photometry": photometry,
            "metadata": obj["metadata24"][t].astype(np.float32),
            "image": obj["images"][t].astype(np.float32),
            "spectrum": obj["spectrum"].astype(np.float32),
            "label": int(obj["label"]),
            "mean": self.mean,
            "std": self.std,
        }

    def collate(self, samples: list[dict]) -> dict:
        base = collate_photometry(samples, max_len=self.max_len)["data"]
        base["metadata"] = np.stack([s["metadata"] for s in samples])
        base["image"] = np.stack([s["image"] for s in samples])
        base["spectrum"] = np.stack([s["spectrum"] for s in samples])
        return {"data": base}


register_dataset(FusionDataset, name=FusionDataset.SECTION)
