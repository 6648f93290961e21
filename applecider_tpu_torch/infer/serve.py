"""Raw-alert serving: ZTF object directories on disk -> per-alert class
probabilities (counterpart of ``applecider_tpu/infer/serve.py``).

An alert arrives -> causal featurisation of its object up to that alert's
jd -> the per-modality encoders -> fusion -> class probabilities. The host
side reads the raw L1 layout (``<data_dir>/<obj_id>/{photometry.csv,
alerts.npy, spectra.csv}``) into the ragged per-alert sample dicts that
``infer.stream.pack_alert_batch`` takes: the causal photometry prefix, the
alert's three decoded cutouts, its 19-column metadata vector and, once it
was taken, the object's spectrum. From there ``FusedSpectraStream`` (with
``LengthBinnedFeeder`` when binned) runs merge, featurisation, resampling
and the model on the device.

Host reading uses no pandas (``preprocessing.table``). Stamps decode in
one call of the native decoder (``native.decode_stamps_batch``) for all the
3n stamps of an object's servable alerts; an alert whose three stamps do
not all decode to (hw, hw) takes the per-stamp ladder of
``preprocessing.fitsio.decode_stamp``, which centre pads or crops. The
samples are the JAX package's bit for bit.
"""

from __future__ import annotations

import itertools
import json
import time
import warnings
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from applecider_tpu_torch.infer.stream import (
    LENGTH_BUCKETS, FusedSpectraStream, LengthBinnedFeeder, _has_spectrum, decimate_spectrum,
)
from applecider_tpu_torch.native import decode_stamps_batch
from applecider_tpu_torch.preprocessing.builder import ALERT_META_KEEP, _meta_vector
from applecider_tpu_torch.preprocessing.config import JD_MJD_OFFSET
from applecider_tpu_torch.preprocessing.fitsio import decode_stamp
from applecider_tpu_torch.preprocessing.photometry import load_photometry
from applecider_tpu_torch.preprocessing.spectra import (
    extract_spectrum_time_mjd, raw_spectrum_columns, read_spectra_csv,
)
from applecider_tpu_torch.preprocessing.table import Table

CUTOUT_KEYS = ("cutoutScience", "cutoutTemplate", "cutoutDifference")
N_META19 = 19
assert len(ALERT_META_KEEP) >= N_META19


def _fit_hw(plane: np.ndarray, hw: int = 63) -> np.ndarray:
    """Center pad/crop a stamp plane to (hw, hw): live cutouts at survey
    edges arrive short."""
    h, w = plane.shape
    if h == hw and w == hw:
        return plane
    out = np.zeros((hw, hw), plane.dtype)
    src_y = slice(max(0, (h - hw) // 2), max(0, (h - hw) // 2) + min(h, hw))
    src_x = slice(max(0, (w - hw) // 2), max(0, (w - hw) // 2) + min(w, hw))
    dst_y = slice(max(0, (hw - h) // 2), max(0, (hw - h) // 2) + min(h, hw))
    dst_x = slice(max(0, (hw - w) // 2), max(0, (hw - w) // 2) + min(w, hw))
    out[dst_y, dst_x] = plane[src_y, src_x]
    return out


def _alert_triplet(alert: dict, hw: int = 63) -> Optional[np.ndarray]:
    """Decode THIS alert's three cutouts into an NHWC (hw, hw, 3) image."""
    try:
        planes = [decode_stamp(alert[k]["stampData"]) for k in CUTOUT_KEYS]
    except (KeyError, TypeError, ValueError):
        return None
    if any(p is None for p in planes):
        return None
    return np.stack([_fit_hw(p.astype(np.float32), hw) for p in planes], axis=-1)


def _decode_all_triplets(alerts: list, hw: int = 63) -> list[Optional[np.ndarray]]:
    """Each alert's (hw, hw, 3) image, or None, from one native call for
    all 3n stamps; an alert whose three stamps do not all decode to
    (hw, hw) (short edge cutouts, a missing or undecodable stamp) takes
    ``_alert_triplet``."""
    blobs: list = []
    for alert in alerts:
        for k in CUTOUT_KEYS:
            try:
                blob = alert[k]["stampData"]
            except (KeyError, TypeError):
                blob = None
            blobs.append(blob if isinstance(blob, (bytes, bytearray, np.ndarray)) else b"")
    images, ok = decode_stamps_batch(blobs, hw=hw)
    return [np.stack(list(images[3 * i:3 * i + 3]), axis=-1) if ok[3 * i:3 * i + 3].all()
            else _alert_triplet(alert, hw) for i, alert in enumerate(alerts)]


def _raw_spectrum(df: Optional[Table],
                  max_points: int = 512) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Raw (wavelength, flux) columns; interp + MAD happen on device.

    Spectra longer than ``max_points`` (the packed spectra width — real
    instrument exports run to thousands of samples) are bin-averaged down
    to ``max_points`` segments covering the FULL wavelength range: naive
    ``[:max_points]`` truncation would keep only the bluest stub and let
    the device resample extrapolate garbage across most of the grid."""
    raw = raw_spectrum_columns(df)
    if raw is None:
        return None
    x, y = decimate_spectrum(*raw, max_points)
    return np.asarray(x, np.float32), np.asarray(y, np.float32)


def alert_samples_for_object(
    obj_id: str,
    data_dir: str | Path,
    causal_spectrum: bool = True,
    hw: int = 63,
) -> Iterator[tuple[dict, dict]]:
    """Yield ``(info, sample)`` per decodable alert of one object.

    ``sample`` follows ``pack_alert_batch``'s contract (raw ragged arrays;
    the device pipeline merges/featurizes). Causal cuts: photometry rows
    with jd <= the alert's jd; the object's spectrum rides along only when
    it was taken on or before the alert (``causal_spectrum=False`` attaches
    it unconditionally, the archived evaluate-everything behavior).

    ``info``: {object_id, jd, fid, n_photometry, has_spectrum}.
    """
    data_dir = Path(data_dir)
    alerts_path = data_dir / obj_id / "alerts.npy"
    if not alerts_path.exists():
        return
    arr = np.load(alerts_path, allow_pickle=True)
    alerts = list(arr) if isinstance(arr, np.ndarray) else arr
    photo = load_photometry(obj_id, data_dir, alerts=alerts)
    if len(photo["jd"]) == 0:
        return

    spec_df = read_spectra_csv(obj_id, data_dir)
    spec = _raw_spectrum(spec_df)
    spec_jd = None
    if spec is not None:
        spec_mjd = extract_spectrum_time_mjd(spec_df)
        spec_jd = None if spec_mjd is None else spec_mjd + JD_MJD_OFFSET

    # photometry columns, time-ascending once; per alert it's a prefix slice
    order = np.argsort(photo["jd"], kind="stable")
    jd_sorted = photo["jd"][order]
    t = photo["mjd"][order].astype(np.float32)  # rebased to first detection
    flux = photo["flux"][order].astype(np.float32)
    err = photo["flux_error"][order].astype(np.float32)
    # load_photometry guarantees fid in {1,2,3}; do NOT clip defensively —
    # an out-of-range band must reach the device merge's in_band guard
    # (stream.py) and stay unmerged, exactly like the training corpus,
    # rather than being silently folded into g-band
    band = photo["fid"][order].astype(np.int32) - 1

    cand_jd = []
    for alert in alerts:
        cand = alert.get("candidate", alert) if isinstance(alert, dict) else {}
        try:
            cand_jd.append(float(cand["jd"]))
        except (KeyError, TypeError, ValueError):
            cand_jd.append(np.nan)
    finite = [k for k in range(len(alerts)) if np.isfinite(cand_jd[k])]
    triplets = dict(zip(finite, _decode_all_triplets([alerts[k] for k in finite], hw)))
    for k in np.argsort(np.asarray(cand_jd), kind="stable"):
        jd_a = cand_jd[k]
        if not np.isfinite(jd_a):
            continue
        alert = alerts[k]
        image = triplets[k]
        if image is None:
            continue  # reference policy: an alert needs all three cutouts
        n = int(np.searchsorted(jd_sorted, jd_a, side="right"))
        if n == 0:
            continue  # alert precedes every photometry row (clock skew)
        cand = dict(alert.get("candidate", alert))
        sample = {
            "photo_t": t[:n],
            "photo_flux": flux[:n],
            "photo_err": err[:n],
            "photo_band": band[:n],
            "image": image,
            "meta19": _meta_vector(cand)[:N_META19],
        }
        has_spec = spec is not None and (
            not causal_spectrum or (spec_jd is not None and spec_jd <= jd_a)
        )
        if has_spec:
            sample["spec_wl"], sample["spec_flux"] = spec
        yield (
            {
                "object_id": obj_id,
                "jd": jd_a,
                "fid": int(cand.get("fid", 0) or 0),
                "n_photometry": n,
                "has_spectrum": bool(has_spec),
            },
            sample,
        )


def iter_alert_samples(
    data_dir: str | Path,
    obj_ids: Optional[list[str]] = None,
    causal_spectrum: bool = True,
) -> Iterator[tuple[dict, dict]]:
    """Stream ``(info, sample)`` over every object directory under
    ``data_dir`` (or the given ids), alerts in per-object time order."""
    data_dir = Path(data_dir)
    if obj_ids is None:
        obj_ids = sorted(
            p.parent.name for p in data_dir.glob("*/alerts.npy")
        )
    for obj_id in obj_ids:
        try:
            yield from alert_samples_for_object(
                obj_id, data_dir, causal_spectrum=causal_spectrum
            )
        except Exception as e:  # noqa: BLE001 — the reference's skip-and-log policy
            # one corrupt object must not kill a live stream
            warnings.warn(
                f"skipping object {obj_id}: {type(e).__name__}: {e}",
                stacklevel=2,
            )


def serve_alert_stream(
    model,
    samples: Iterator[tuple[dict, dict]],
    batch_size: int = 1024,
    length_buckets: tuple[int, ...] = LENGTH_BUCKETS,
    binned: bool = True,
    stats_mean=None,
    stats_std=None,
    wave_grid: Optional[np.ndarray] = None,
    out_jsonl: Optional[str | Path] = None,
    horizon_days: Optional[float] = 100.0,
    device="cuda",
    kernels: bool = True,
    int8: bool = False,
    calib_alerts: int = 64,
) -> dict:
    """Classify a stream of ``(info, sample)`` pairs with the port's
    ``model``; returns a summary dict.

    ``binned=True`` routes through ``LengthBinnedFeeder`` (homogeneous
    length buckets); ``False`` packs arrival-order batches straight into
    ``FusedSpectraStream``. Outputs are the same either way (binning only
    reorders batch membership). One batch stays in flight: a batch is read
    back once the next one is enqueued. ``kernels=False`` runs the plain
    versions of the kernels (the yardstick).

    ``int8=True`` (opt-in; accuracy depends on the workload) calibrates
    int8 activation scales (``ops.quant``) on the stream's first
    ``calib_alerts`` alerts, eagerly on the model's device, then serves the
    whole stream, those alerts included, through the quantized router.
    Leading alerts rarely carry a spectrum (one attaches only once taken),
    so when none of them does, up to ``20 * calib_alerts`` further alerts
    are read ahead until 4 spectrum carriers join the calibration batch.
    As in the JAX package, the quantized router takes the default horizon
    (100 days), not ``horizon_days``.

    Results are ``summary["results"]``: the input ``info`` dicts extended
    with ``probs``, in arrival order (and written as JSONL when
    ``out_jsonl`` is given). ``summary["batches"]`` counts the forwards
    that served them, and ``summary["quant_scales"]`` holds the int8
    scales (None without ``int8``).
    """
    router = FusedSpectraStream(model, stats_mean=stats_mean, stats_std=stats_std,
                                wave_grid=wave_grid, horizon_days=horizon_days,
                                device=device, kernels=kernels)
    samples = iter(samples)
    scales = None
    if int8:
        head = list(itertools.islice(samples, calib_alerts))
        extra: list = []
        if head and not any(_has_spectrum(s) for _, s in head):
            for pair in itertools.islice(samples, 20 * calib_alerts):
                extra.append(pair)
                if sum(_has_spectrum(s) for _, s in extra) >= 4:
                    break
        samples = itertools.chain(head, extra, samples)
        if head:
            calib = head + [p for p in extra if _has_spectrum(p[1])]
            placed = router.place([s for _, s in calib], length_buckets=length_buckets)
            scales = router.pipe.calibrate([placed])
            router = FusedSpectraStream(model, stats_mean=stats_mean, stats_std=stats_std,
                                        wave_grid=wave_grid, quantize_scales=scales,
                                        device=device, kernels=kernels)
    infos: list[dict] = []
    probs_by_idx: dict[int, np.ndarray] = {}
    pending: list = []

    def resolve_oldest():
        idxs, res = pending.pop(0)
        out = res()
        for j, i in enumerate(idxs):
            probs_by_idx[i] = out[j]

    n_batches = 0

    def drain(ready):
        nonlocal n_batches
        for entry in ready:
            n_batches += 1
            pending.append(entry)
            while len(pending) > 1:
                resolve_oldest()

    t0 = time.perf_counter()
    if binned:
        feeder = LengthBinnedFeeder(router, flush_bs=batch_size, length_buckets=length_buckets,
                                    device=device)
        for info, sample in samples:
            idx = len(infos)
            infos.append(info)
            drain(feeder.submit([(idx, sample)]))
        drain(feeder.flush())
    else:
        batch: list[tuple[int, dict]] = []

        def flush():
            if batch:
                placed = router.place([s for _, s in batch], length_buckets=length_buckets)
                drain([([i for i, _ in batch], router.run_placed(placed))])
                batch.clear()

        for info, sample in samples:
            idx = len(infos)
            infos.append(info)
            batch.append((idx, sample))
            if len(batch) >= batch_size:
                flush()
        flush()
    while pending:
        resolve_oldest()
    elapsed = time.perf_counter() - t0

    results = []
    for i, info in enumerate(infos):
        rec = dict(info)
        rec["probs"] = np.asarray(probs_by_idx[i], np.float32)
        results.append(rec)
    if out_jsonl is not None:
        with open(out_jsonl, "w") as f:
            for rec in results:
                row = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                       for k, v in rec.items()}
                f.write(json.dumps(row) + "\n")
    return {
        "n_alerts": len(infos),
        "seconds": elapsed,
        "alerts_per_sec": len(infos) / elapsed if elapsed > 0 else 0.0,
        "batches": n_batches,
        "quant_scales": scales,
        "results": results,
    }
