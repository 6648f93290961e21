"""Per-object multimodal builder and corpus build (counterpart of
``applecider_tpu/preprocessing/builder.py``).

Per object: merge the photometry into events, attach the best cutout
triplet and the alert metadata per event (in-window, carry-forward and
nearest policies, recorded in ``provenance``), compute the causal context
features, resample and normalise the spectrum, and write one
``<obj>.npz`` with the JAX package's keys, dtypes and order. The corpus
build scans the available ids, maps the sorted class names to label ints,
builds every object (skip and log on failure; optionally in a spawn pool)
and writes ``built_all.csv``. The alert-metadata vector (``_meta_vector``:
the candidate fields kept per alert, ra/dec scaled, -999 where a field is
missing or not a finite number) also feeds raw-alert serving.
"""

from __future__ import annotations

import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

from applecider_tpu_torch.preprocessing.alerts import AlertIndex
from applecider_tpu_torch.preprocessing.config import FIDS, JD_MJD_OFFSET, PreprocessConfig
from applecider_tpu_torch.preprocessing.events import (
    CTX_COLUMNS, EVENT_COLUMNS, build_event_features, context_features, event_matrix,
)
from applecider_tpu_torch.preprocessing.manifest import find_available_ids, write_manifest_csv
from applecider_tpu_torch.preprocessing.photometry import load_photometry, merge_by_filter
from applecider_tpu_torch.preprocessing.spectra import (
    extract_spectrum_time_mjd, preprocess_spectrum, read_spectra_csv,
)
from applecider_tpu_torch.preprocessing.table import Table

ALERT_META_KEEP = (
    "sgscore1", "sgscore2", "distpsnr1", "distpsnr2", "nmtchps", "sharpnr",
    "scorr", "ra", "dec", "diffmaglim", "sky", "ndethist", "ncovhist",
    "sigmapsf", "chinr", "magpsf", "classtar", "fid", "rb", "chipsf",
    "distnr", "magnr", "ranr", "decnr", "fwhm",
    "srmag1", "sgmag1", "simag1", "szmag1",
    "srmag2", "sgmag2", "simag2", "szmag2",
    "clrcoeff", "clrcounc", "zpclrcov",
)
META_COLUMNS = ALERT_META_KEEP + CTX_COLUMNS
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


def build_multimodal_for_object(
    obj_id: str,
    label_int: int,
    label_str: Optional[str],
    out_dir: Path,
    cfg: PreprocessConfig,
) -> Optional[dict]:
    out_dir = Path(out_dir)

    # photometry -> merged events
    alerts_path = cfg.data_dir / obj_id / "alerts.npy"
    if not alerts_path.exists():
        return None
    arr = np.load(alerts_path, allow_pickle=True)
    alerts = list(arr) if isinstance(arr, np.ndarray) else arr

    photo = load_photometry(obj_id, cfg.data_dir, alerts=alerts)
    if len(photo["jd"]) == 0:
        return None
    merged = merge_by_filter(photo, cfg.delta_t_hours)
    if len(merged["mjd"]) == 0:
        return None
    events = build_event_features(merged)
    n_events = len(events["jd"])
    if n_events == 0:
        return None

    index = AlertIndex(alerts, require_all_3=cfg.require_all_3_cuts)
    ctx = context_features(merged, events["jd"])  # (T, 10)
    event_mat = event_matrix(events)  # (T, 14)

    images, meta_rows, event_rows, jds, fids, prov_rows = [], [], [], [], [], []
    last_choice: dict[int, Optional[tuple]] = {f: None for f in FIDS}

    for e in range(n_events):
        fid = int(events["fid"][e])
        jd = float(events["jd"][e])

        pick = index.best_in_window_by_sig(fid, jd, cfg.alert_tol_days)
        policy = "in_window_min_sigmapsf"
        if pick is None and last_choice[fid] is not None:
            img, cand, ajd = last_choice[fid]
            dt_days = abs(jd - ajd)
            policy = "fallback_last_in_filter"
        else:
            if pick is None and cfg.allow_fallback_nearest_any:
                near = index.nearest_any(fid, jd)
                if near is not None and cfg.max_nearest_any_dt_days is not None:
                    if abs(near[3]) > cfg.max_nearest_any_dt_days:
                        near = None
                if near is not None:
                    policy = "fallback_nearest_any"
                    pick = near
            if pick is None:
                continue  # nothing attachable for this event
            img, cand, ajd, dt_days = pick

        extras = np.where(np.isfinite(ctx[e]), ctx[e], MISSING).astype(np.float32)
        meta_rows.append(np.concatenate([_meta_vector(cand), extras]))
        images.append(img.astype(np.float32))
        event_rows.append(event_mat[e])
        jds.append(jd)
        fids.append(fid)
        prov_rows.append(
            {
                "jd_event": jd,
                "fid": fid,
                "jd_alert": float(ajd),
                "alert_dt_days": float(dt_days),
                "alert_matched": 1 if policy == "in_window_min_sigmapsf" else 0,
                "select_policy": policy,
            }
        )
        last_choice[fid] = (img, cand, float(ajd))

    if not images:
        return None

    # spectra
    spec_df = read_spectra_csv(obj_id, cfg.data_dir)
    wave_grid = cfg.wave_grid()
    spec_flux = preprocess_spectrum(spec_df, wave_grid)
    spec_mjd_abs = extract_spectrum_time_mjd(spec_df)
    photo_mjd0_abs = float(photo["jd"].min() - JD_MJD_OFFSET)
    spec_dt = float(spec_mjd_abs - photo_mjd0_abs) if spec_mjd_abs is not None else np.nan
    spec_jd = float(spec_mjd_abs + JD_MJD_OFFSET) if spec_mjd_abs is not None else np.nan

    if spec_flux is None:
        spectrum_vec = np.zeros((0,), np.float32)
        spectrum_wave = np.zeros((0,), np.float32)
        has_spectrum = np.int8(0)
    else:
        spectrum_vec = spec_flux
        spectrum_wave = wave_grid.astype(np.float32)
        has_spectrum = np.int8(1)

    order = np.argsort(np.asarray(jds), kind="stable")
    out_path = out_dir / f"{obj_id}.npz"
    out_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        out_path,
        images=np.stack(images, axis=0)[order],
        event_data=np.stack(event_rows, axis=0).astype(np.float32)[order],
        event_columns=np.array(EVENT_COLUMNS, dtype="U"),
        meta_data=np.stack(meta_rows, axis=0).astype(np.float32)[order],
        meta_columns=np.array(META_COLUMNS, dtype="U"),
        jd=np.asarray(jds, np.float64)[order],
        fid=np.asarray(fids, np.int16)[order],
        label=np.int64(label_int),
        label_str=np.array(label_str or "", dtype="U"),
        provenance=np.asarray(prov_rows, dtype=object)[order],
        spectrum=spectrum_vec,
        spectrum_wavelength=spectrum_wave,
        spectrum_dt=np.array(spec_dt, np.float64),
        spectrum_jd=np.array(spec_jd, np.float64),
        has_spectrum=np.array(has_spectrum, np.int8),
    )
    return {
        "object_id": obj_id,
        "filepath": str(out_path),
        "label": int(label_int),
        "label_str": label_str or "",
        "n_events": int(len(images)),
        "has_spectrum": int(has_spectrum),
        "spectrum_dt": spec_dt,
    }


def _build_one(args):
    obj_id, label_int, label_str, out_dir, cfg = args
    try:
        return build_multimodal_for_object(obj_id, label_int, label_str, out_dir, cfg)
    except Exception:
        print(f"{obj_id} failed:\n{traceback.format_exc()}")
        return None


def build_all_preprocessed(cfg: PreprocessConfig) -> Table:
    """Build every available object; returns the ``built_all.csv`` table.
    An object that fails to build is skipped and its traceback printed."""
    out_root = Path(cfg.output_root)
    out_all = out_root / "all"
    out_all.mkdir(parents=True, exist_ok=True)

    avail = find_available_ids(cfg.spec_csv, cfg.data_dir)
    classes = sorted(set(avail["type"]))
    label2id = {c: i for i, c in enumerate(classes)}
    print(f"Available locally: {len(set(avail['object_id']))} objects, {len(classes)} classes.")

    jobs = [
        (obj_id, int(label2id[typ]), typ, out_all, cfg)
        for obj_id, typ in zip(avail["object_id"], avail["type"])
    ]
    if cfg.num_workers and cfg.num_workers > 1:
        # spawn, not fork: the parent may run threads (torch's, a loader's),
        # and os.fork() under live threads can deadlock. Workers import this
        # module (the port alone); the job tuples are picklable plain data.
        import multiprocessing as mp

        with ProcessPoolExecutor(
            max_workers=cfg.num_workers, mp_context=mp.get_context("spawn")
        ) as pool:
            results = list(pool.map(_build_one, jobs))
    else:
        results = [_build_one(j) for j in jobs]

    recs = [r for r in results if r is not None and r.get("n_events", 0) > 0]
    manifest = write_manifest_csv(recs, out_root / "built_all.csv", name="built_all.csv")
    print(f"Built objects: {len(manifest)}")
    return manifest
