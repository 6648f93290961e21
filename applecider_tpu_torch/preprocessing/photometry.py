"""Photometry ingest (counterpart of ``applecider_tpu/preprocessing/
photometry.py``, the part the serving path reads): magnitudes to microJy
flux with zeropoint 23.9, csv and alert-candidate photometry unified with
fid/filter columns normalised, duplicates on (fid, round(jd, 5)) dropped
with csv rows winning, mjd rebased to the first detection.

``photometry.csv`` is read with ``preprocessing.table`` (no pandas) into
the same columns ``pandas.read_csv`` gives. The host merge
(``merge_groups``, ``merge_weighted``, ``merge_by_filter``) builds the
training corpus; serving merges on the device (``infer.stream``, K1).

Tables are plain dicts of NumPy column arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.preprocessing.config import BAND2FID, JD_MJD_OFFSET
from applecider_tpu_torch.preprocessing.table import read_csv

LOG10 = np.log(10.0)

PHOTO_COLUMNS = ("jd", "mjd", "mag", "magerr", "flux", "flux_error", "fid")


def mag_to_flux(mag, magerr):
    """AB mag (zp 23.9) -> microJy flux and its error."""
    mag = np.asarray(mag, dtype=np.float64)
    magerr = np.asarray(magerr, dtype=np.float64)
    flux = 10.0 ** (-0.4 * (mag - 23.9))
    flux_err = magerr / (2.5 / LOG10) * flux
    return flux, flux_err


def _empty_table() -> dict:
    return {c: np.empty(0, dtype=np.int16 if c == "fid" else np.float64) for c in PHOTO_COLUMNS}


def _normalize_fid(fid_col, filter_col, n: int) -> np.ndarray:
    """Resolve a per-row fid in {1,2,3} from fid and/or filter name columns."""
    fid = np.zeros(n, dtype=np.int16)
    if fid_col is not None:
        vals = np.asarray(fid_col)
        for i, v in enumerate(vals):
            try:
                iv = int(float(v))
            except (TypeError, ValueError):
                continue
            if iv in (1, 2, 3):
                fid[i] = iv
    if filter_col is not None:
        name_map = {"ztfg": 1, "ztfr": 2, "ztfi": 3, "g": 1, "r": 2, "i": 3}
        vals = np.asarray(filter_col)
        for i, v in enumerate(vals):
            if fid[i] == 0 and isinstance(v, str):
                fid[i] = name_map.get(v.strip().lower(), 0)
    return fid


def read_csv_photometry(obj_id: str, data_dir: Path) -> dict:
    """Load <obj>/photometry.csv into a column table (may be empty)."""
    path = Path(data_dir) / obj_id / "photometry.csv"
    if not path.exists():
        return _empty_table()
    df = read_csv(path)
    cols = {c.lower(): c for c in df.columns}

    def get(*names):
        for n in names:
            if n in cols:
                return df[cols[n]]
        return None

    mag = get("mag", "magpsf")
    magerr = get("magerr", "sigmapsf")
    jd = get("jd", "jdobs")
    mjd = get("mjd")
    if mag is None or magerr is None or (jd is None and mjd is None):
        return _empty_table()
    n = len(df)
    if jd is None:
        jd = np.asarray(mjd, dtype=np.float64) + JD_MJD_OFFSET
    jd = np.asarray(jd, dtype=np.float64)
    mjd = jd - JD_MJD_OFFSET if mjd is None else np.asarray(mjd, dtype=np.float64)
    mag = np.asarray(mag, dtype=np.float64)
    magerr = np.asarray(magerr, dtype=np.float64)
    fid = _normalize_fid(get("fid"), get("filter"), n)

    keep = np.isfinite(jd) & np.isfinite(mjd) & np.isfinite(mag) & np.isfinite(magerr) & (fid > 0)
    flux, flux_err = mag_to_flux(mag[keep], magerr[keep])
    return {
        "jd": jd[keep], "mjd": mjd[keep], "mag": mag[keep], "magerr": magerr[keep],
        "flux": flux, "flux_error": flux_err, "fid": fid[keep],
    }


def read_alert_photometry(alerts: list) -> dict:
    """Extract candidate-level photometry rows from a list of alert dicts."""
    rows = {c: [] for c in ("jd", "mag", "magerr", "fid")}
    for alert in alerts:
        cand = alert.get("candidate", {}) if isinstance(alert, dict) else {}
        try:
            jd = float(cand["jd"])
            mag = float(cand.get("magpsf", np.nan))
            magerr = float(cand.get("sigmapsf", np.nan))
            fid = int(cand.get("fid", 0))
        except (KeyError, TypeError, ValueError):
            continue
        if not (np.isfinite(jd) and np.isfinite(mag) and np.isfinite(magerr)) or fid not in (1, 2, 3):
            continue
        rows["jd"].append(jd)
        rows["mag"].append(mag)
        rows["magerr"].append(magerr)
        rows["fid"].append(fid)
    if not rows["jd"]:
        return _empty_table()
    jd = np.asarray(rows["jd"], dtype=np.float64)
    mag = np.asarray(rows["mag"], dtype=np.float64)
    magerr = np.asarray(rows["magerr"], dtype=np.float64)
    flux, flux_err = mag_to_flux(mag, magerr)
    return {
        "jd": jd, "mjd": jd - JD_MJD_OFFSET, "mag": mag, "magerr": magerr,
        "flux": flux, "flux_error": flux_err,
        "fid": np.asarray(rows["fid"], dtype=np.int16),
    }


def _concat_tables(a: dict, b: dict) -> dict:
    return {c: np.concatenate([a[c], b[c]]) for c in PHOTO_COLUMNS}


def dedup_prefer_first_source(csv_tab: dict, alert_tab: dict, jd_round_decimals: int = 5) -> dict:
    """Drop duplicate (fid, round(jd, 5)) rows, csv rows winning over alerts."""
    uni = _concat_tables(csv_tab, alert_tab)
    n_csv = len(csv_tab["jd"])
    n = len(uni["jd"])
    if n == 0:
        return uni
    jd_round = np.round(uni["jd"], jd_round_decimals)
    # lexsort with "csv first" as tiebreak (csv rows have priority 0)
    priority = np.concatenate([np.zeros(n_csv, np.int8), np.ones(n - n_csv, np.int8)])
    order = np.lexsort((priority, jd_round, uni["fid"]))
    fid_s, jd_s = uni["fid"][order], jd_round[order]
    first_of_group = np.ones(n, dtype=bool)
    first_of_group[1:] = (fid_s[1:] != fid_s[:-1]) | (jd_s[1:] != jd_s[:-1])
    keep_idx = np.sort(order[first_of_group])
    return {c: uni[c][keep_idx] for c in PHOTO_COLUMNS}


def load_photometry(obj_id: str, data_dir: Path, alerts: list | None = None) -> dict:
    """Unified, deduplicated photometry with mjd rebased to first detection."""
    csv_tab = read_csv_photometry(obj_id, data_dir)
    if alerts is None:
        alerts_path = Path(data_dir) / obj_id / "alerts.npy"
        if alerts_path.exists():
            arr = np.load(alerts_path, allow_pickle=True)
            alerts = list(arr) if isinstance(arr, np.ndarray) else arr
        else:
            alerts = []
    alert_tab = read_alert_photometry(alerts)
    uni = dedup_prefer_first_source(csv_tab, alert_tab)
    if len(uni["jd"]) == 0:
        return uni
    uni["mjd"] = uni["mjd"] - uni["mjd"].min()
    return uni


def merge_groups(time: np.ndarray, dt_days: float) -> np.ndarray:
    """Greedy window starts over a sorted time array: group g spans
    [start[g], start[g+1]), every point within dt_days of the group's
    first point."""
    starts = []
    i, n = 0, len(time)
    while i < n:
        starts.append(i)
        i = int(np.searchsorted(time, time[i] + dt_days, side="right"))
    return np.asarray(starts, dtype=np.int64)


def merge_weighted(time, flux, err, dt_days: float, eps: float = 1e-8):
    """Inverse-error-weighted collapse of greedy 12 h windows."""
    time = np.asarray(time, dtype=np.float64)
    flux = np.asarray(flux, dtype=np.float64)
    err = np.asarray(err, dtype=np.float64)
    if len(time) == 0:
        return time, flux, err
    starts = merge_groups(time, dt_days)
    w = 1.0 / (err + eps)
    wsum = np.add.reduceat(w, starts)
    t_out = np.add.reduceat(w * time, starts) / wsum
    f_out = np.add.reduceat(w * flux, starts) / wsum
    e_out = np.add.reduceat(w * err, starts) / wsum
    return t_out, f_out, e_out


def merge_by_filter(photo: dict, delta_t_hours: float = 12.0) -> dict:
    """Per-band merge; returns a merged table with jd reconstructed per band."""
    out = {c: [] for c in ("mjd", "flux", "flux_error", "jd", "fid")}
    dt_days = delta_t_hours / 24.0
    for fid in BAND2FID.values():
        sel = photo["fid"] == fid
        if not sel.any():
            continue
        order = np.argsort(photo["mjd"][sel], kind="stable")
        mjd = photo["mjd"][sel][order]
        flux = photo["flux"][sel][order]
        err = photo["flux_error"][sel][order]
        jd_offset = photo["jd"][sel].min() - photo["mjd"][sel].min()
        t, f, e = merge_weighted(mjd, flux, err, dt_days)
        out["mjd"].append(t)
        out["flux"].append(f)
        out["flux_error"].append(e)
        out["jd"].append(t + jd_offset)
        out["fid"].append(np.full(len(t), fid, dtype=np.int16))
    if not out["mjd"]:
        return {c: np.empty(0) for c in out}
    return {c: np.concatenate(v) for c, v in out.items()}
