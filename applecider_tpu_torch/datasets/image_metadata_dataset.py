"""Per-alert image + metadata dataset, the AstroMiNN input (the port's copy
of ``applecider_tpu/datasets/image_metadata_dataset.py``):

* every ``.npy`` sample dict {obj_id, image (3, 63, 63), metadata (24,),
  target} of a directory (``preprocessing.alert_samples.
  build_alert_samples`` writes them), loaded in file-name order;
* the coarse 5-group taxonomy (``CLASS_GROUPS``) and the fine 9-class one
  (``REAL_CLASSES``), with one-hot ``get_target`` / ``get_real_target``; a
  target in neither group is warned about, trains with an all-zero one-hot
  and is never replicated by the oversampler;
* a center crop to ``cutout_size`` (the ViT patch with the ``vit_tower``
  tag), then the ``median`` (per channel, median and std) or ``L2`` image
  norm, with an optional image cache;
* optional oversampling toward ``class_distribution`` (``Oversampler``,
  seeded from ``data_loader.seed``).
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path

import numpy as np

from applecider_tpu_torch.datasets.oversampler import Oversampler
from applecider_tpu_torch.registry import register_dataset

EPS = 1e-8

REAL_CLASSES = ("AGN", "TDE", "SN II", "SN IIp", "SN Ia", "SN IIn", "SN Ib", "SN Ic",
                "Cataclysmic")

CLASS_GROUPS = (
    ("SN Ia", "SN Ic", "SN Ib"),
    ("SN IIP", "SN IIp", "SN IIn", "SN II", "SN IIb"),
    ("Cataclysmic",),
    ("AGN",),
    ("Tidal Disruption Event", "TDE"),
)


def coarse_group(class_name: str) -> int:
    """The index of the group holding ``class_name``, or -1."""
    for gid, group in enumerate(CLASS_GROUPS):
        if class_name in group:
            return gid
    return -1


@register_dataset(name="ImageAndMetadataDataset")
class ImageAndMetadataDataset:
    SECTION = "applecider_tpu.datasets.image_metadata_dataset.ImageAndMetadataDataset"

    def __init__(self, config, data_location):
        section = config.section("data_set", self.SECTION)
        self.section = section
        files = sorted(f for f in os.listdir(data_location) if f.endswith(".npy"))
        self.records = [np.load(Path(data_location) / f, allow_pickle=True).item() for f in files]
        self.obj_ids = [r.get("obj_id") for r in self.records]
        self.enable_cache = bool(section.get("enable_image_cache", False))
        self._cache: dict[int, np.ndarray] = {}
        self.class_at_index = np.asarray(
            [coarse_group(str(r.get("target"))) for r in self.records], np.int64)
        n_unknown = int((self.class_at_index < 0).sum())
        if n_unknown:
            warnings.warn(
                f"{n_unknown} records have unrecognized targets; they are "
                "excluded from oversampling and train with all-zero one-hots")
        self.use_oversampling = bool(section.get("use_oversampling", False))
        self.oversampler = None
        if self.use_oversampling:
            self.oversampler = Oversampler(
                section.get("class_distribution", [0.3, 0.1, 0.1, 0.3, 0.1]),
                self.class_at_index, seed=int(config.get_path("data_loader.seed", 42)))

    def __len__(self) -> int:
        return len(self.oversampler) if self.oversampler is not None else len(self.records)

    def _resolve(self, idx: int) -> int:
        if self.oversampler is not None:
            idx, _ = self.oversampler.resolve(idx)
        return idx

    def _crop_bounds(self) -> tuple[int, int]:
        if "vit_tower" in self.section.get("tags", []):
            size = int(self.section["patch_size"][0])
        else:
            size = int(self.section.get("cutout_size", 63))
        if size == 63:
            return 0, 63
        i1 = (63 - size) // 2
        return i1, i1 + size  # size pixels for even sizes too (63 - i1 is one more)

    def get_image(self, idx: int) -> np.ndarray:
        idx = self._resolve(idx)
        if self.enable_cache and idx in self._cache:
            return self._cache[idx]
        image = np.asarray(self.records[idx].get("image"), np.float32)
        i1, i2 = self._crop_bounds()
        image = image[:, i1:i2, i1:i2]
        norm = self.section.get("image_norm", False)
        if norm == "median":
            med = np.median(image.reshape(image.shape[0], -1), axis=1)
            image = image - med[:, None, None]
            std = image.reshape(image.shape[0], -1).std(axis=1)
            image = image / (std[:, None, None] + EPS)
        elif norm == "L2":
            image = image / (np.linalg.norm(image) + EPS)
        if self.enable_cache:
            self._cache[idx] = image
        return image

    def get_metadata(self, idx: int) -> np.ndarray:
        return np.asarray(self.records[self._resolve(idx)].get("metadata"), np.float32)

    def get_target(self, idx: int) -> np.ndarray:
        """One-hot coarse 5-group target."""
        target = np.zeros(len(CLASS_GROUPS), np.float32)
        gid = coarse_group(str(self.records[self._resolve(idx)].get("target")))
        if gid >= 0:
            target[gid] = 1.0
        return target

    def get_real_target(self, idx: int) -> np.ndarray:
        """One-hot fine 9-class target."""
        name = str(self.records[self._resolve(idx)].get("target"))
        target = np.zeros(len(REAL_CLASSES), np.float32)
        if name in REAL_CLASSES:
            target[REAL_CLASSES.index(name)] = 1.0
        return target

    def get_obj_id(self, idx: int):
        return self.obj_ids[self._resolve(idx)]

    def ids(self):
        for i in range(len(self)):
            yield self.get_obj_id(i)

    def sample(self, idx: int) -> dict:
        return {"image": self.get_image(idx), "metadata": self.get_metadata(idx),
                "target": self.get_target(idx)}

    @staticmethod
    def collate(samples: list[dict]) -> dict:
        return {"data": {
            "image": np.stack([s["image"] for s in samples]),
            "metadata": np.stack([s["metadata"] for s in samples]),
            "target": np.stack([s["target"] for s in samples]),
        }}


register_dataset(ImageAndMetadataDataset, name=ImageAndMetadataDataset.SECTION)
