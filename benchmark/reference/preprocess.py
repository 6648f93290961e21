"""Plain preprocessing of served alerts, one alert at a time in NumPy
(float64), from the serving path's published description:

1. the light curve in time order (stable), its earliest ``max_points``;
2. the greedy 12-hour merge per band: an observation more than half a day
   after the first observation of its band's current group starts a new
   group; a group's time, flux and error are their means weighted by
   1 / (error + 1e-8), its band that of its first observation; the groups
   in order of merged time (ties: the earlier first observation);
3. the seven features of each merged event (log1p of the time since the
   first event and since the previous one, log10 flux, the flux error in
   log10 units, the band one-hot), events more than ``horizon`` days after
   the first masked, the four continuous ones standardised;
4. the ten context values over all merged events, five of which follow the
   19 alert metadata values;
5. a spectrum, averaged down to ``spec_points`` equal-count bins when longer,
   interpolated linearly onto the wavelength grid (extrapolated from the end
   segments), then centred on its mean and divided by its median absolute
   deviation (else its standard deviation, else 1).
"""

from __future__ import annotations

import numpy as np

MERGE_DAYS = 0.5
EPS = 1e-8
GRID = np.linspace(4500.0, 7980.0, 3481, dtype=np.float32).astype(np.float64)
CONTEXT_COLUMNS = (0, 1, 3, 4, 6)


def merge(t, flux, err, band):
    """Merged (t, flux, err, band) arrays of one light curve in time order."""
    start = {}  # band -> (first time, group id) of its open group
    group = np.empty(len(t), np.int64)
    for i in range(len(t)):
        b = int(band[i])
        if b not in start or t[i] > start[b][0] + MERGE_DAYS:
            start[b] = (t[i], i)
        group[i] = start[b][1]
    ids = np.unique(group)
    w = 1.0 / (err + EPS)
    out = []
    for g in ids:
        sel = group == g
        ws = max(w[sel].sum(), EPS)
        out.append(((w[sel] * t[sel]).sum() / ws, (w[sel] * flux[sel]).sum() / ws,
                    (w[sel] * err[sel]).sum() / ws, band[g], g))
    out.sort(key=lambda r: (r[0], r[4]))
    cols = np.asarray(out, np.float64).reshape(-1, 5)
    return cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3].astype(np.int64)


def features(t, f, e, band, horizon, mean, std):
    """(n_kept, 7) standardised features and the (10,) context."""
    t0 = t[0]
    keep = t - t0 <= horizon if horizon is not None else np.ones(len(t), bool)
    n = int(keep.sum())  # the merged times ascend, so the kept events lead
    dt = t[:n] - t0
    dt_prev = np.diff(np.concatenate([[t0], t[:n]]))
    fc = np.maximum(f[:n], 1e-6)
    feats = np.zeros((n, 7))
    feats[:, 0] = np.log1p(dt)
    feats[:, 1] = np.log1p(dt_prev)
    feats[:, 2] = np.log10(fc)
    feats[:, 3] = e[:n] / np.log(10.0) / fc
    feats[np.arange(n), 4 + band[:n]] = 1.0
    feats[:, :4] = (feats[:, :4] - mean) / (std + 1e-8)

    mag = -2.5 * np.log10(np.maximum(f, 1e-12))
    t_peak = t[int(np.argmax(f))]
    since, to = t.max() - t_peak, t_peak - t0
    peak, faint = mag.min(), mag.max()
    ratio = faint / peak if peak != 0 else np.nan
    counts = np.bincount(band, minlength=3)[:3].astype(np.float64)
    ctx = np.array([since, to, since + to, peak, faint, ratio, counts.sum(), *counts])
    return feats, np.where(np.isfinite(ctx), ctx, -999.0)


def fit_spectrum(wl, flux, points):
    """The spectrum in wavelength order, averaged down to ``points``
    equal-count bins when it is longer."""
    order = np.argsort(wl, kind="stable")
    wl, flux = np.asarray(wl, np.float64)[order], np.asarray(flux, np.float64)[order]
    n = len(wl)
    if n > points:
        edges = np.linspace(0, n, points + 1).astype(np.int64)
        wl = np.add.reduceat(wl, edges[:-1]) / np.diff(edges)
        flux = np.add.reduceat(flux, edges[:-1]) / np.diff(edges)
    return wl, flux


def resample(wl, flux, grid=GRID):
    """Linear interpolation onto ``grid``, extrapolated from the end
    segments, then (x - mean) / MAD."""
    out = np.interp(grid, wl, flux)
    left = grid < wl[0]
    out[left] = flux[0] + (flux[1] - flux[0]) / max(wl[1] - wl[0], 1e-12) * (grid[left] - wl[0])
    right = grid > wl[-1]
    out[right] = flux[-1] + (flux[-1] - flux[-2]) / max(wl[-1] - wl[-2], 1e-12) * (
        grid[right] - wl[-1])
    med = np.median(out)
    mad = np.median(np.abs(out - med))
    std = out.std()
    scale = mad if mad > 0 else (std if std > 0 else 1.0)
    return (out - out.mean()) / scale


def alert_inputs(alert: dict, horizon, mean, std, max_points: int = 257,
                 spec_points: int = 512) -> dict:
    """The model's inputs for one alert: ``photometry`` (n, 7),
    ``metadata`` (24,), ``image`` (63, 63, 3), ``spectrum`` (3481,)."""
    order = np.argsort(np.asarray(alert["photo_t"], np.float32), kind="stable")[:max_points]
    cols = [np.asarray(alert[k], np.float32)[order].astype(np.float64)
            for k in ("photo_t", "photo_flux", "photo_err")]
    band = np.asarray(alert["photo_band"], np.int64)[order]
    feats, ctx = features(*merge(*cols, band), horizon, np.asarray(mean, np.float64),
                          np.asarray(std, np.float64))
    wl = alert.get("spec_wl")
    spectrum = (resample(*fit_spectrum(wl, alert["spec_flux"], spec_points))
                if wl is not None and len(wl) >= 2 else np.zeros(len(GRID)))
    return {
        "photometry": feats,
        "metadata": np.concatenate([np.asarray(alert["meta19"], np.float64),
                                    ctx[list(CONTEXT_COLUMNS)]]),
        "image": np.asarray(alert["image"], np.float64),
        "spectrum": spectrum,
    }
