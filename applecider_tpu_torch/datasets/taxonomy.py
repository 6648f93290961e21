"""Transient class taxonomies (the port's copy of
``applecider_tpu/datasets/taxonomy.py``).

Behavioral contract from the reference's label tables:

* fine 10-class ordering (``_archive/AppleCider/preprocess/
  data_preprocessor.py:269-281``);
* coarse 5-class grouping SN I / SN II / CV / AGN / TDE (``:236-249``,
  ``core/dataset.py:36-48``, ``photo_dataset.py:26-37``);
* 4-class grouping with all SNe merged (``:252-267``);
* 9-class spectra labels (``src/applecider/datasets/spectra_dataset.py:15-25``).

All mappings are keyed by class *name* so they are independent of any
particular label2id ordering.
"""

from __future__ import annotations

import numpy as np

FINE_10 = (
    "SN Ia", "SN Ic", "SN Ib", "SN II", "SN IIP",
    "SN IIn", "SN IIb", "Cataclysmic", "AGN", "Tidal Disruption Event",
)

COARSE_5 = ("SN I", "SN II", "Cataclysmic", "AGN", "Tidal Disruption Event")

COARSE_4 = ("SN", "Cataclysmic", "AGN", "Tidal Disruption Event")

SPECTRA_9 = (
    "AGN", "Cataclysmic", "SN IIP", "SN IIb", "SN IIn",
    "SN Ia", "SN Ib", "SN Ic", "Tidal Disruption Event",
)

_SN_I = {"SN Ia", "SN Ib", "SN Ic", "SN I"}
_SN_II = {"SN II", "SN IIP", "SN IIp", "SN IIn", "SN IIb"}


def to_coarse5(name: str) -> int:
    if name in _SN_I:
        return 0
    if name in _SN_II:
        return 1
    if name == "Cataclysmic":
        return 2
    if name == "AGN":
        return 3
    if name in ("Tidal Disruption Event", "TDE"):
        return 4
    return -1


def to_coarse4(name: str) -> int:
    if name in _SN_I or name in _SN_II or name == "SN":
        return 0
    if name == "Cataclysmic":
        return 1
    if name == "AGN":
        return 2
    if name in ("Tidal Disruption Event", "TDE"):
        return 3
    return -1


def to_fine10(name: str) -> int:
    try:
        return FINE_10.index(name)
    except ValueError:
        return -1


def map_labels(names, taxonomy: str = "coarse5") -> np.ndarray:
    """Vector-map class names under 'fine10' | 'coarse5' | 'coarse4'."""
    fn = {"fine10": to_fine10, "coarse5": to_coarse5, "coarse4": to_coarse4}[taxonomy]
    return np.asarray([fn(str(n)) for n in names], np.int64)


def downsample_per_class(
    labels: np.ndarray, max_samples: int, seed: int = 42
) -> np.ndarray:
    """Indices after capping each class at max_samples (seeded sample).

    Reference semantics: ``data_preprocessor.py:288-295``.
    """
    rng = np.random.RandomState(seed)
    keep = []
    for cls in np.unique(labels):
        idx = np.where(labels == cls)[0]
        if len(idx) > max_samples:
            idx = rng.choice(idx, size=max_samples, replace=False)
        keep.append(idx)
    return np.sort(np.concatenate(keep))
