"""Preprocessing constants and configuration (counterpart of
``applecider_tpu/preprocessing/config.py``): merge window 12 h, alert match
tolerance +-0.5 d, spectrum grid 4500-7980 A at 1 A (3481 bins)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class PreprocessConfig:
    data_dir: Path
    spec_csv: Path
    output_root: Path

    # photometry merge window
    delta_t_hours: float = 12.0

    # alert matching
    alert_tol_days: float = 0.5
    require_all_3_cuts: bool = True
    allow_fallback_nearest_any: bool = True
    max_nearest_any_dt_days: Optional[float] = None

    # spectra grid
    spectrum_wave_min: float = 4500.0
    spectrum_wave_max: float = 7980.0
    spectrum_step: float = 1.0

    random_seed: int = 42
    num_workers: int = 0

    def __post_init__(self):
        object.__setattr__(self, "data_dir", Path(self.data_dir))
        object.__setattr__(self, "spec_csv", Path(self.spec_csv))
        object.__setattr__(self, "output_root", Path(self.output_root))

    def wave_grid(self) -> np.ndarray:
        n = int(round((self.spectrum_wave_max - self.spectrum_wave_min) / self.spectrum_step)) + 1
        return np.linspace(self.spectrum_wave_min, self.spectrum_wave_max, n, dtype=np.float32)


FIDS = (1, 2, 3)
FID2BAND = {1: "ztfg", 2: "ztfr", 3: "ztfi"}
BAND2ID = {"ztfg": 0, "ztfr": 1, "ztfi": 2}
BAND2FID = {"ztfg": 1, "ztfr": 2, "ztfi": 3}
JD_MJD_OFFSET = 2400000.5
