"""Per-event featurization of the merged light curve (the port's copy of
``applecider_tpu/preprocessing/events.py``).

Behavioral contract from the reference (``preprocess_multimodal.py:315-364``):

* sort by mjd; dt = mjd - mjd[0]; dt_prev = successive differences (first 0);
* logflux = log10(clip(flux, 1e-6)); logflux_err = flux_err/(ln10 * flux_clipped);
* one-hot band columns (ztfg, ztfr, ztfi);
* colors: for every g event, g-r against the *nearest* r event within 1 day
  (and r-i for r events against i), with quadrature errors; has_g_r/has_r_i
  flags; absent colors stay NaN.

The reference's pandas ``merge_asof`` becomes a searchsorted
nearest-neighbor here; the per-event context features
(``context_metrics_up_to`` / ``counts_per_filter_up_to``, reference
``:370-396``) are computed as O(T) prefix scans instead of the reference's
O(T^2) re-filtering per event.
"""

from __future__ import annotations

import numpy as np

from applecider_tpu_torch.preprocessing.config import BAND2ID

LOG_CONST = 1.0 / np.log(10.0)
COLOR_TOL_DAYS = 1.0

EVENT_COLUMNS = (
    "dt", "dt_prev", "band_id", "logflux", "logflux_err",
    "band_ztfg", "band_ztfr", "band_ztfi",
    "g_r", "g_r_err", "r_i", "r_i_err", "has_g_r", "has_r_i",
)

CTX_COLUMNS = (
    "days_since_peak", "days_to_peak", "age_sum_days",
    "peakmag_so_far", "maxmag_so_far", "max_over_peak_mag",
    "n_photometry_total", "n_photometry_fid_1", "n_photometry_fid_2", "n_photometry_fid_3",
)


def _nearest_within(query_t: np.ndarray, ref_t: np.ndarray, tol: float) -> np.ndarray:
    """Index of the nearest ref_t for each query_t within tol, else -1."""
    if len(ref_t) == 0:
        return np.full(len(query_t), -1, dtype=np.int64)
    pos = np.searchsorted(ref_t, query_t)
    left = np.clip(pos - 1, 0, len(ref_t) - 1)
    right = np.clip(pos, 0, len(ref_t) - 1)
    d_left = np.abs(query_t - ref_t[left])
    d_right = np.abs(query_t - ref_t[right])
    idx = np.where(d_left <= d_right, left, right)
    dist = np.minimum(d_left, d_right)
    return np.where(dist <= tol, idx, -1)


def build_event_features(merged: dict) -> dict:
    """Merged table -> per-event feature table sorted by mjd."""
    n = len(merged["mjd"])
    if n == 0:
        return {c: np.empty(0, dtype=np.float32) for c in EVENT_COLUMNS} | {
            "jd": np.empty(0, np.float64), "fid": np.empty(0, np.int16)
        }
    order = np.argsort(merged["mjd"], kind="stable")
    mjd = merged["mjd"][order]
    flux = merged["flux"][order]
    flux_err = merged["flux_error"][order]
    jd = merged["jd"][order]
    fid = merged["fid"][order].astype(np.int16)

    dt = (mjd - mjd[0]).astype(np.float32)
    dt_prev = np.diff(np.concatenate([[mjd[0]], mjd])).astype(np.float32)
    f = np.clip(flux.astype(np.float32), 1e-6, None)
    logf = np.log10(f).astype(np.float32)
    sig_logf = (flux_err.astype(np.float32) * LOG_CONST / f).astype(np.float32)
    band_id = (fid - 1).astype(np.int8)  # fid 1/2/3 -> band 0/1/2

    out: dict = {
        "dt": dt, "dt_prev": dt_prev,
        "band_id": band_id.astype(np.float32),
        "logflux": logf, "logflux_err": sig_logf,
    }
    for band, idx in BAND2ID.items():
        out[f"band_{band}"] = (band_id == idx).astype(np.float32)

    # colors from clipped-flux magnitudes (reference :339-361)
    mag = -2.5 * np.log10(f)
    sigma_m = 2.5 * LOG_CONST * flux_err / f

    g_r = np.full(n, np.nan, np.float32)
    g_r_err = np.full(n, np.nan, np.float32)
    r_i = np.full(n, np.nan, np.float32)
    r_i_err = np.full(n, np.nan, np.float32)

    is_g, is_r, is_i = band_id == 0, band_id == 1, band_id == 2
    for src_mask, ref_mask, val, err_out in (
        (is_g, is_r, g_r, g_r_err),
        (is_r, is_i, r_i, r_i_err),
    ):
        src_idx = np.where(src_mask)[0]
        ref_idx = np.where(ref_mask)[0]
        match = _nearest_within(mjd[src_idx], mjd[ref_idx], COLOR_TOL_DAYS)
        ok = match >= 0
        tgt = src_idx[ok]
        ref = ref_idx[match[ok]]
        val[tgt] = (mag[tgt] - mag[ref]).astype(np.float32)
        err_out[tgt] = np.sqrt(sigma_m[tgt] ** 2 + sigma_m[ref] ** 2).astype(np.float32)

    out["g_r"], out["g_r_err"] = g_r, g_r_err
    out["r_i"], out["r_i_err"] = r_i, r_i_err
    out["has_g_r"] = (~np.isnan(g_r)).astype(np.float32)
    out["has_r_i"] = (~np.isnan(r_i)).astype(np.float32)
    out["jd"] = jd
    out["fid"] = fid
    return out


def event_matrix(events: dict) -> np.ndarray:
    """Stack the 14 EVENT_COLUMNS into the (T, 14) event_data array."""
    return np.stack([np.asarray(events[c], dtype=np.float32) for c in EVENT_COLUMNS], axis=1)


def context_features(merged: dict, event_jds: np.ndarray) -> np.ndarray:
    """Causal context features for each event cut, via prefix scans.

    Row semantics match the reference's per-event calls
    ``context_metrics_up_to(merged, jd)`` + ``counts_per_filter_up_to``:
    statistics over all merged rows with jd <= event jd. NaN-able entries
    (max_over_peak_mag when peakmag==0) are emitted as NaN and sanitized to
    -999 downstream, like every missing metadata value.
    """
    n = len(merged["jd"])
    order = np.argsort(merged["jd"], kind="stable")
    jd = merged["jd"][order]
    flux = merged["flux"][order]
    fid = merged["fid"][order]

    mag = -2.5 * np.log10(np.clip(flux, 1e-12, None))
    # prefix scans
    cum_argmax = np.zeros(n, dtype=np.int64)
    best = 0
    for i in range(1, n):  # tiny host loop over merged rows (T is small)
        if flux[i] > flux[best]:
            best = i
        cum_argmax[i] = best
    cum_min_mag = np.minimum.accumulate(mag)
    cum_max_mag = np.maximum.accumulate(mag)
    cum_fid = {f: np.cumsum(fid == f) for f in (1, 2, 3)}

    # position of each event cut in the sorted-jd prefix
    pos = np.searchsorted(jd, event_jds, side="right") - 1
    out = np.full((len(event_jds), len(CTX_COLUMNS)), np.nan, dtype=np.float64)
    valid = pos >= 0
    p = pos[valid]
    peak_idx = cum_argmax[p]
    last_jd = jd[p]
    first_jd = jd[0]
    days_since = last_jd - jd[peak_idx]
    days_to = jd[peak_idx] - first_jd
    peakmag = cum_min_mag[p]
    maxmag = cum_max_mag[p]
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(peakmag != 0, maxmag / peakmag, np.nan)
    counts = np.stack([cum_fid[f][p] for f in (1, 2, 3)], axis=1).astype(np.float64)
    out[valid, 0] = days_since
    out[valid, 1] = days_to
    out[valid, 2] = days_since + days_to
    out[valid, 3] = peakmag
    out[valid, 4] = maxmag
    out[valid, 5] = ratio
    out[valid, 6] = counts.sum(axis=1)
    out[valid, 7:10] = counts
    return out
