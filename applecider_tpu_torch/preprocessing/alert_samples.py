"""The 24-column AstroMiNN metadata of a multimodal npz (counterpart of
``applecider_tpu/preprocessing/alert_samples.py:29``): columns 0..18 are
``ALERT_META_KEEP[:19]`` (sgscore1..rb, ra/dec pre-scaled) and columns
19..23 the light-curve context block [days_since_peak, days_to_peak,
peakmag_so_far, maxmag_so_far, n_photometry_total]."""

from __future__ import annotations

import numpy as np

ALERT_META_24_CONTEXT = (
    "days_since_peak", "days_to_peak", "peakmag_so_far", "maxmag_so_far", "n_photometry_total",
)


def metadata24_from_npz(meta_data: np.ndarray, meta_columns) -> np.ndarray:
    """(T, 46) multimodal meta matrix -> (T, 24) AstroMiNN metadata."""
    cols = {c: i for i, c in enumerate(meta_columns)}
    first19 = meta_data[:, :19]
    ctx = np.stack([meta_data[:, cols[c]] for c in ALERT_META_24_CONTEXT], axis=1)
    return np.concatenate([first19, ctx], axis=1).astype(np.float32)
