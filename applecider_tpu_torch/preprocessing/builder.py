"""The alert-metadata vector of the per-object builder (counterpart of
``applecider_tpu/preprocessing/builder.py:49-77``): the candidate fields
kept per alert, ra/dec scaled, -999 where a field is missing or not a
finite number. The rest of the builder (events, the corpus build) is
training-side preprocessing and is not ported."""

from __future__ import annotations

import numpy as np

ALERT_META_KEEP = (
    "sgscore1", "sgscore2", "distpsnr1", "distpsnr2", "nmtchps", "sharpnr",
    "scorr", "ra", "dec", "diffmaglim", "sky", "ndethist", "ncovhist",
    "sigmapsf", "chinr", "magpsf", "classtar", "fid", "rb", "chipsf",
    "distnr", "magnr", "ranr", "decnr", "fwhm",
    "srmag1", "sgmag1", "simag1", "szmag1",
    "srmag2", "sgmag2", "simag2", "szmag2",
    "clrcoeff", "clrcounc", "zpclrcov",
)
MISSING = -999.0


def _meta_vector(cand: dict) -> np.ndarray:
    vals = np.full(len(ALERT_META_KEEP), MISSING, dtype=np.float32)
    for i, key in enumerate(ALERT_META_KEEP):
        v = cand.get(key, MISSING)
        try:
            v = float(v)
        except (TypeError, ValueError):
            continue
        if key == "ra":
            v = v / 180.0 - 1.0
        elif key == "dec":
            v = v / 90.0
        if np.isfinite(v):
            vals[i] = v
    return vals
