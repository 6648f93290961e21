"""Spectra ingest, resampling and normalization (counterpart of
``applecider_tpu/preprocessing/spectra.py``):

* column-name sniffing for wavelength/flux;
* observation time from MJD columns, JD columns (-2400000.5), or an ISO
  ``observed_at`` timestamp (median over rows for numeric columns);
* for the training corpus, linear interpolation with extrapolation onto the
  fixed 4500-7980 A grid on the host, then (x - mean)/MAD normalization with
  a std fallback when the MAD is 0 (``preprocess_spectrum``).

``spectra.csv`` is read with ``preprocessing.table`` (no pandas); a "frame"
here is a ``table.Table``, and ``pd.to_numeric(errors="coerce")`` is
``table.to_numeric``. Serving resamples and normalises on the device
(``infer.stream``) instead.
"""

from __future__ import annotations

import csv
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import numpy as np

from applecider_tpu_torch.preprocessing.table import Table, read_csv, to_numeric

_MJD_EPOCH = datetime(1858, 11, 17, tzinfo=timezone.utc)

_MJD_COLS = ["observed_at_mjd", "mjd", "MJD", "MJD_OBS", "mjd_obs", "spec_mjd", "MJD-OBS", "mjd-obs"]
_JD_COLS = ["jd", "JD", "obs_jd", "JD_OBS"]
_WL_CANDIDATES = ["wavelength", "wave", "lambda", "lam", "wl", "Wavelength"]
_FLUX_CANDIDATES = ["flux", "Flux", "FLUX", "fluxcal", "flam"]


def iso_to_mjd(iso: str) -> float:
    s = iso.strip().replace("Z", "+00:00")
    dt = datetime.fromisoformat(s)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return (dt - _MJD_EPOCH).total_seconds() / 86400.0


def mad(x: np.ndarray) -> float:
    """Median absolute deviation (scale=1), NaN-omitting."""
    x = np.asarray(x, dtype=np.float64)
    med = np.nanmedian(x)
    return float(np.nanmedian(np.abs(x - med)))


def interp_with_extrapolation(x: np.ndarray, y: np.ndarray, x_new: np.ndarray) -> np.ndarray:
    """Linear interp; linear extrapolation from the boundary segments."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    x_new = np.asarray(x_new, dtype=np.float64)
    order = np.argsort(x, kind="stable")
    x, y = x[order], y[order]
    finite = np.isfinite(x) & np.isfinite(y)
    x, y = x[finite], y[finite]
    if len(x) < 2:
        return np.full_like(x_new, np.nan)
    y_new = np.interp(x_new, x, y)
    left = x_new < x[0]
    if left.any():
        slope = (y[1] - y[0]) / (x[1] - x[0])
        y_new[left] = y[0] + slope * (x_new[left] - x[0])
    right = x_new > x[-1]
    if right.any():
        slope = (y[-1] - y[-2]) / (x[-1] - x[-2])
        y_new[right] = y[-1] + slope * (x_new[right] - x[-1])
    return y_new


def _is_missing(v) -> bool:
    return isinstance(v, float) and np.isnan(v)


def read_spectra_csv(obj_id: str, data_dir: Path) -> Optional[Table]:
    """Load <obj>/spectra.csv (or None when it is missing or unreadable);
    with a ``ZTFID`` column, only the rows of ``obj_id`` and those with no
    id are kept."""
    path = Path(data_dir) / obj_id / "spectra.csv"
    if not path.exists():
        return None
    try:
        df = read_csv(path)
    except (OSError, ValueError, csv.Error):  # unreadable: no spectrum, as in the JAX reader
        return None
    if "ZTFID" in df:
        keep = [_is_missing(v) or str(v) == str(obj_id) for v in df["ZTFID"]]
        df = df.take(np.asarray(keep, bool))
    return df


def extract_spectrum_time_mjd(df: Optional[Table]) -> Optional[float]:
    if df is None or len(df) == 0:
        return None
    for col in _MJD_COLS:
        if col in df:
            vals = to_numeric(df[col])
            if np.isfinite(vals).any():
                return float(np.nanmedian(vals))
    for col in _JD_COLS:
        if col in df:
            vals = to_numeric(df[col])
            if np.isfinite(vals).any():
                return float(np.nanmedian(vals) - 2400000.5)
    if "observed_at" in df:
        for v in df["observed_at"]:
            if _is_missing(v):
                continue
            try:
                return iso_to_mjd(str(v))
            except ValueError:
                continue
    return None


def raw_spectrum_columns(df: Optional[Table]) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Finite ``(wavelength, flux)`` float64 arrays sorted by wavelength
    from a spectra table, or None when no usable pair exists."""
    if df is None or len(df) == 0:
        return None
    cols = set(df.columns)
    wl_col = next((c for c in _WL_CANDIDATES if c in cols), None)
    fx_col = next((c for c in _FLUX_CANDIDATES if c in cols), None)
    if wl_col is None or fx_col is None:
        return None
    x = to_numeric(df[wl_col])
    y = to_numeric(df[fx_col])
    good = np.isfinite(x) & np.isfinite(y)
    if good.sum() < 2:
        return None
    order = np.argsort(x[good], kind="stable")
    return x[good][order], y[good][order]


def preprocess_spectrum(df: Optional[Table], wave_grid: np.ndarray) -> Optional[np.ndarray]:
    """A spectra table -> MAD-normalized flux on the fixed grid (float32),
    or None."""
    raw = raw_spectrum_columns(df)
    if raw is None:
        return None
    x, y = raw
    y_grid = interp_with_extrapolation(x, y, wave_grid.astype(np.float64))
    mean = float(np.nanmean(y_grid))
    scale = mad(y_grid)
    if not np.isfinite(scale) or scale == 0.0:
        std = float(np.nanstd(y_grid))
        scale = std if np.isfinite(std) and std > 0 else 1.0
    return ((y_grid - mean) / scale).astype(np.float32)
