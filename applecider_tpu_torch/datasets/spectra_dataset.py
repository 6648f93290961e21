"""Spectra table dataset (the port's copy of
``applecider_tpu/datasets/spectra_dataset.py``): a table of {flux, labels,
redshifts, file_paths} with the 9-class label map; a sample is the flux,
the integer label and the redshift.

Tables are ``.npz``, or the reference's ``.pt`` tables, read with
``torch.load(weights_only=False)`` as the JAX package reads them (a
pickle: load only tables you trust). With ``augment``, each sample's flux
is edge-cropped (``augment_edge_crop``) with draws from one
``numpy.random.default_rng(data_loader.seed)``, so the draws equal the JAX
dataset's one for one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.registry import register_dataset

LABEL_STRINGS = {
    "AGN": 0,
    "Cataclysmic": 1,
    "SN IIP": 2,
    "SN IIb": 3,
    "SN IIn": 4,
    "SN Ia": 5,
    "SN Ib": 6,
    "SN Ic": 7,
    "Tidal Disruption Event": 8,
}

# spelling variants the rest of the taxonomy uses
_LABEL_ALIASES = {"SN IIp": "SN IIP", "TDE": "Tidal Disruption Event", "CV": "Cataclysmic"}


def _label_index(label: str) -> int:
    """The 9-class index of ``label`` or of its variant; ``ValueError``
    naming the expected labels otherwise."""
    key = _LABEL_ALIASES.get(label, label)
    if key in LABEL_STRINGS:
        return LABEL_STRINGS[key]
    raise ValueError(
        f"unknown spectra label {label!r}; expected one of "
        f"{sorted(LABEL_STRINGS)} (or variants {sorted(_LABEL_ALIASES)})")


def _load_table(path: str | Path) -> dict:
    path = Path(path)
    if path.suffix == ".pt":
        import torch

        table = torch.load(path, weights_only=False)
        return {
            "flux": np.asarray(
                [t.numpy() if hasattr(t, "numpy") else np.asarray(t) for t in table["flux"]]),
            "labels": list(table["labels"]),
            "redshifts": np.asarray(table["redshifts"], np.float32),
            "file_paths": list(table.get("file_paths", [])),
        }
    with np.load(path, allow_pickle=True) as npz:
        return {
            "flux": npz["flux"],
            "labels": list(npz["labels"]),
            "redshifts": np.asarray(npz["redshifts"], np.float32),
            "file_paths": list(npz.get("file_paths", [])),
        }


def augment_edge_crop(flux: np.ndarray, rng: np.random.Generator, max_frac: float = 0.25
                      ) -> np.ndarray:
    """Zero a random edge of up to ``max_frac`` of the bins on each side
    (two draws: the left count, then the right)."""
    n = flux.shape[-1]
    left = int(rng.integers(0, int(n * max_frac) + 1))
    right = int(rng.integers(0, int(n * max_frac) + 1))
    out = flux.copy()
    if left:
        out[..., :left] = 0.0
    if right:
        out[..., n - right:] = 0.0
    return out


@register_dataset(name="SpectraDataset")
@register_dataset(name="SpectraData")
class SpectraDataset:
    SECTION = "applecider_tpu.datasets.spectra_dataset.SpectraDataset"

    def __init__(self, config, data_location):
        section = config.section("data_set", self.SECTION)
        self.augment = bool(section.get("augment", False))
        self._rng = np.random.default_rng(int(config.get_path("data_loader.seed", 42)))
        table = _load_table(data_location)
        self._flux = np.asarray(table["flux"], np.float32)
        if self._flux.ndim == 3:  # stored with a channel axis
            self._flux = self._flux[:, 0, :]
        self._labels = table["labels"]
        self._label_idx = np.asarray([_label_index(str(label)) for label in self._labels],
                                     np.int32)
        self._redshifts = table["redshifts"]
        self._file_paths = table["file_paths"]

    def __len__(self) -> int:
        return len(self._flux)

    def ids(self):
        return np.arange(len(self._flux))

    def get_object_id(self, idx: int) -> int:
        return int(idx)

    def get_flux(self, idx: int) -> np.ndarray:
        """(1, L): the flux with a channel axis, as the reference returns it."""
        return self._flux[idx][None, :]

    def get_label(self, idx: int) -> int:
        return int(self._label_idx[idx])

    def get_redshift(self, idx: int) -> float:
        return float(self._redshifts[idx])

    def sample(self, idx: int) -> dict:
        flux = self._flux[idx]
        if self.augment:
            flux = augment_edge_crop(flux, self._rng)
        return {"flux": flux, "label": self.get_label(idx), "redshift": self.get_redshift(idx)}

    @staticmethod
    def collate(samples: list[dict]) -> dict:
        return {"data": {
            "flux": np.stack([s["flux"] for s in samples]),
            "label": np.asarray([s["label"] for s in samples], np.int32),
            "redshift": np.asarray([s["redshift"] for s in samples], np.float32),
        }}


register_dataset(SpectraDataset, name=SpectraDataset.SECTION)
