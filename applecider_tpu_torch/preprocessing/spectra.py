"""Spectra ingest for serving (counterpart of ``applecider_tpu/
preprocessing/spectra.py``: ``read_spectra_csv``, ``extract_spectrum_time_mjd``,
``iso_to_mjd``, ``raw_spectrum_columns``):

* column-name sniffing for wavelength/flux;
* observation time from MJD columns, JD columns (-2400000.5), or an ISO
  ``observed_at`` timestamp (median over rows for numeric columns).

``spectra.csv`` is read with ``preprocessing.table`` (no pandas); a "frame"
here is a ``table.Table``, and ``pd.to_numeric(errors="coerce")`` is
``table.to_numeric``. Resampling onto the grid and MAD normalisation run on
the device (``infer.stream``).
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
