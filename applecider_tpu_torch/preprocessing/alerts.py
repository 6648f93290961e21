"""Alert/cutout matching (the port's copy of
``applecider_tpu/preprocessing/alerts.py``).

Behavioral contract from the reference (``preprocess_multimodal.py:401-523``
``AlertIndex``): per-fid time-sorted index of alerts carrying all three
cutouts; for an event at (fid, jd) pick the minimum-sigmapsf alert within
+-tol days, else carry forward the last choice in that filter, else the
nearest decodable alert in time; record the policy in provenance.

Improvements over the reference: decoded cutout triplets are cached (the
reference re-gunzips the same stamps once per event), and the FITS decode
is astropy-free (``preprocessing.fitsio``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from applecider_tpu_torch.preprocessing.config import FIDS
from applecider_tpu_torch.preprocessing.fitsio import decode_stamp

CUTOUT_KEYS = ("cutoutScience", "cutoutTemplate", "cutoutDifference")


class AlertIndex:
    def __init__(self, alerts: list, require_all_3: bool = True):
        self.require_all_3 = require_all_3
        self._triplet_cache: dict[int, Optional[tuple]] = {}
        per_fid: dict[int, list] = {f: [] for f in FIDS}
        for alert in alerts:
            if not isinstance(alert, dict):
                continue
            cand = alert.get("candidate", alert)
            try:
                jd = float(cand["jd"])
                fid = int(cand["fid"])
            except (KeyError, TypeError, ValueError):
                continue
            if fid not in FIDS:
                continue
            try:
                for key in CUTOUT_KEYS:
                    _ = alert[key]["stampData"]
            except (KeyError, TypeError):
                continue
            try:
                sig = float(cand.get("sigmapsf", np.inf))
            except (TypeError, ValueError):
                sig = np.inf
            per_fid[fid].append((jd, sig, alert))
        self.by_fid: dict[int, dict] = {}
        for fid in FIDS:
            rows = sorted(per_fid[fid], key=lambda r: r[0])
            self.by_fid[fid] = {
                "jd": np.asarray([r[0] for r in rows], dtype=np.float64),
                "sig": np.asarray([r[1] for r in rows], dtype=np.float64),
                "alerts": [r[2] for r in rows],
            }

    def _triplet(self, alert: dict) -> Optional[tuple[np.ndarray, dict, float]]:
        """(stacked sci/tmpl/diff image (3,H,W), candidate meta, alert jd) or None."""
        key = id(alert)
        if key in self._triplet_cache:
            return self._triplet_cache[key]
        result = None
        try:
            planes = [decode_stamp(alert[k]["stampData"]) for k in CUTOUT_KEYS]
            if all(p is not None for p in planes):
                img = np.stack([p.astype(np.float32) for p in planes], axis=0)
                cand = dict(alert.get("candidate", alert))
                result = (img, cand, float(cand["jd"]))
        except (KeyError, TypeError, ValueError):
            result = None
        self._triplet_cache[key] = result
        return result

    def best_in_window_by_sig(self, fid: int, jd: float, tol_days: float):
        """Min-sigmapsf decodable alert within +-tol_days, or None.

        Returns (image, meta, alert_jd, |dt|).
        """
        pack = self.by_fid.get(fid)
        if pack is None or len(pack["jd"]) == 0:
            return None
        jds = pack["jd"]
        lo = int(np.searchsorted(jds, jd - tol_days, side="left"))
        hi = int(np.searchsorted(jds, jd + tol_days, side="right"))
        if hi <= lo:
            return None
        order = lo + np.argsort(pack["sig"][lo:hi], kind="stable")
        for k in order:
            trip = self._triplet(pack["alerts"][k])
            if trip is None:
                continue
            img, meta, ajd = trip
            return img, meta, ajd, abs(ajd - jd)
        return None

    def nearest_any(self, fid: int, jd: float):
        """Nearest-in-time alert regardless of window, or None.

        Matches the reference exactly (preprocess_multimodal.py
        ``get_nearest_any`` :495-523): only the TWO time-bracketing alerts
        are considered — if both fail to decode, this returns None even
        when a farther alert would decode. Deliberate parity, not a bug."""
        pack = self.by_fid.get(fid)
        if pack is None or len(pack["jd"]) == 0:
            return None
        jds = pack["jd"]
        pos = int(np.searchsorted(jds, jd))
        best = None
        best_dt = np.inf
        for k in (pos, pos - 1):
            if 0 <= k < len(jds):
                trip = self._triplet(pack["alerts"][k])
                if trip is None:
                    continue
                img, meta, ajd = trip
                dt = abs(ajd - jd)
                if dt < best_dt:
                    best_dt = dt
                    best = (img, meta, ajd, dt)
        return best
