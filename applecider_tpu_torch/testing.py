"""Synthetic data for the port's smoke test and tests, drawn from NumPy
generators seeded by ``seed``.

* ``make_corpus`` (with ``make_object_dir`` and ``make_alert``): raw
  per-object directories in the reference's on-disk layout,
  ``<data_dir>/<obj_id>/{photometry.csv, alerts.npy, spectra.csv}``, alert
  dicts carrying ``candidate`` metadata and gzipped-FITS cutout stamps, and
  a labels csv; the JAX package's ``applecider_tpu/testing.py`` corpus, file
  for file, for the same seed;
* ``make_alert_samples``: raw alerts in ``pack_alert_batch``'s contract, a
  time-ascending light curve (``photo_t``/``photo_flux``/``photo_err``/
  ``photo_band``), a 63x63x3 cutout ``image``, ``meta19`` and, for a
  ``spectrum_frac`` share of the alerts, a raw spectrum
  (``spec_wl``/``spec_flux``);
* ``SyntheticFusionDataset``: featurised training samples in
  ``FusionDataset``'s ``sample``/``collate`` contract.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.preprocessing.fitsio import write_fits_image


def make_alert_samples(n: int, seed: int = 0, spectrum_frac: float = 0.3,
                       length_range: tuple[int, int] = (20, 257),
                       spectrum_points: tuple[int, int] = (80, 2000)) -> list[dict]:
    """``n`` alerts; light-curve lengths and spectrum lengths are uniform
    over the inclusive ranges given."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(n):
        P = int(rng.integers(length_range[0], length_range[1] + 1))
        t = np.sort(rng.uniform(0.0, 120.0, P)).astype(np.float32)
        flux = rng.lognormal(2.0, 1.0, P).astype(np.float32)
        s = {
            "photo_t": t,
            "photo_flux": flux,
            "photo_err": (0.05 * flux + rng.uniform(0.1, 2.0, P)).astype(np.float32),
            "photo_band": rng.integers(0, 3, P).astype(np.int32),
            "image": rng.normal(size=(63, 63, 3)).astype(np.float32),
            "meta19": rng.normal(size=19).astype(np.float32),
        }
        if rng.random() < spectrum_frac:
            m = int(rng.integers(spectrum_points[0], spectrum_points[1] + 1))
            s["spec_wl"] = np.linspace(4000.0, 8500.0, m).astype(np.float32)
            s["spec_flux"] = rng.normal(1.0, 0.3, m).astype(np.float32)
        samples.append(s)
    return samples


class SyntheticFusionDataset:
    """``n`` training samples with ``FusionDataset``'s ``sample``/``collate``
    contract: ``photometry`` (P, 7) of P in [8, max_len] events (four
    continuous channels, then a one-hot band), ``metadata`` (24,),
    ``image`` (63, 63, 3), ``spectrum`` (spec_bins,), ``label`` in [0, 5),
    and the photometry ``mean``/``std``. Sample ``i`` is drawn
    from a generator seeded by (seed, i), so samples need no storage."""

    def __init__(self, n: int, seed: int = 0, max_len: int = 257, spec_bins: int = 3481):
        self.n, self.seed, self.max_len, self.spec_bins = int(n), int(seed), int(max_len), int(spec_bins)
        self.mean = np.array([2.0, 1.0, 3.0, -1.0], np.float32)
        self.std = np.array([1.5, 1.0, 1.0, 0.5], np.float32)

    def __len__(self) -> int:
        return self.n

    def sample(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, int(idx)))
        P = int(rng.integers(8, self.max_len + 1))
        vec4 = rng.standard_normal((P, 4), dtype=np.float32) * self.std + self.mean
        band = np.eye(3, dtype=np.float32)[rng.integers(0, 3, P)]
        return {
            "photometry": np.concatenate([vec4, band], axis=1),
            "metadata": rng.standard_normal(24, dtype=np.float32),
            "image": rng.standard_normal((63, 63, 3), dtype=np.float32),
            "spectrum": rng.standard_normal(self.spec_bins, dtype=np.float32),
            "label": int(rng.integers(0, 5)),
            "mean": self.mean,
            "std": self.std,
        }

    def collate(self, samples: list[dict]) -> dict:
        """Light curves padded to ``max_len`` (True = padded), the rest
        stacked."""
        B = len(samples)
        photometry = np.zeros((B, self.max_len, 7), np.float32)
        pad_mask = np.ones((B, self.max_len), bool)
        for i, s in enumerate(samples):
            n = min(len(s["photometry"]), self.max_len)
            photometry[i, :n] = s["photometry"][:n]
            pad_mask[i, :n] = False
        return {"data": {
            "photometry": photometry, "pad_mask": pad_mask,
            "mean": samples[0]["mean"], "std": samples[0]["std"],
            "label": np.asarray([s["label"] for s in samples], np.int64),
            "metadata": np.stack([s["metadata"] for s in samples]),
            "image": np.stack([s["image"] for s in samples]),
            "spectrum": np.stack([s["spectrum"] for s in samples]),
        }}


# ------------------------------------------------------- raw corpus
CLASS_NAMES = ("SN Ia", "SN II", "Cataclysmic", "AGN", "Tidal Disruption Event")

# a BTS-like class balance (supernovae dominate spectroscopic streams), as
# the JAX package's ``testing.BTS_CLASS_WEIGHTS``
BTS_CLASS_WEIGHTS = (0.55, 0.20, 0.12, 0.09, 0.04)


# ---------------------------------------------------- class-conditioned signal
def _class_mag_curve(cls_idx: int, t_rel: np.ndarray,
                     rng: np.random.Generator) -> np.ndarray:
    """Per-class light-curve template, mag vs days-since-first-detection.

    Coarse astrophysical shapes — fast-declining SN Ia, plateaued SN II,
    outbursting CV, random-walk AGN, power-law TDE — so the photometry
    transformer has real class signal to learn (the learning-demo corpus;
    the default corpus stays class-independent noise for golden tests).
    """
    # per-class brightness level (~0.9 mag apart): a deliberately strong,
    # surviving-the-whole-pipeline discriminant (logflux level) on top of
    # the temporal shapes — the corpus exists to prove the stack LEARNS,
    # so the signal is loud by design
    peak = 16.2 + 0.9 * cls_idx + float(rng.uniform(-0.2, 0.2))
    if cls_idx == 0:  # SN Ia: ~15 d rise, steady decline
        mag = peak + np.where(t_rel < 15, (15 - t_rel) * 0.20,
                              (t_rel - 15) * 0.045)
    elif cls_idx == 1:  # SN II: fast rise, long plateau, late drop
        mag = peak + np.where(t_rel < 7, (7 - t_rel) * 0.30,
                              np.where(t_rel < 80, 0.15, (t_rel - 80) * 0.08))
    elif cls_idx == 2:  # CV: quiescence + sawtooth outbursts
        period = float(rng.uniform(15, 30))
        phase = np.mod(t_rel, period) / period
        outburst = np.where(phase < 0.25, 1.5 * (1 - phase / 0.25), 0.0)
        mag = peak - outburst  # keeps the class's median level in its band
    elif cls_idx == 3:  # AGN: mean-reverting random walk
        steps = rng.normal(0, 0.25, size=len(t_rel))
        walk = np.cumsum(steps) - np.linspace(0, steps.sum(), len(t_rel))
        mag = peak + 0.8 * walk / max(1.0, np.abs(walk).max())
    else:  # TDE: sharp peak, t^(-5/3) flux decay
        mag = peak + (25.0 / 12.0) * np.log10(1.0 + np.maximum(t_rel, 0) / 20.0) * 2.0
    return mag + rng.normal(0, 0.08, size=len(t_rel))


def _class_spectrum(cls_idx: int, wl: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """Continuum + class-specific spectral lines (distinct centers/signs)."""
    cont = 1e-16 * (1.0 + 0.2 * np.sin(wl / 300.0))
    mu = 4800.0 + 650.0 * cls_idx
    sign = 1.0 if cls_idx in (2, 3) else -1.0  # emission vs absorption
    line = sign * 6e-17 * np.exp(-0.5 * ((wl - mu) / 60.0) ** 2)
    line2 = sign * 4e-17 * np.exp(-0.5 * ((wl - mu - 900.0) / 90.0) ** 2)
    return cont + line + line2 + rng.normal(0, 2e-18, size=len(wl))


def _class_stamp(cls_idx: int, hw: int, rng: np.random.Generator,
                 kind: str) -> np.ndarray:
    """Class-conditioned cutout morphology: PSF width + host-galaxy
    component vary per class (AGN nuclear+host, SNe offset point source)."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    cy = cx = (hw - 1) / 2.0
    img = rng.normal(0, 1.0, size=(hw, hw)).astype(np.float32)
    sigma = 1.5 + 0.6 * cls_idx
    amp = 40.0 if kind != "cutoutTemplate" else 10.0
    off = 0.0 if cls_idx == 3 else 3.0 + cls_idx  # AGN is nuclear
    r2 = (yy - cy - off) ** 2 + (xx - cx) ** 2
    img += amp * np.exp(-0.5 * r2 / sigma**2)
    if cls_idx in (1, 3):  # host galaxy: extended elliptical component
        r2h = ((yy - cy) / 2.5) ** 2 + ((xx - cx) / 1.2) ** 2
        img += 15.0 * np.exp(-0.5 * r2h / 16.0)
    return img


def make_alert(rng: np.random.Generator, jd: float, fid: int, stamp_hw: int = 63,
               cls_idx: int | None = None) -> dict:
    mag = float(rng.uniform(16.0, 20.5))
    cand = {
        "jd": jd,
        "fid": fid,
        "magpsf": mag,
        "sigmapsf": float(rng.uniform(0.01, 0.3)),
        "ra": float(rng.uniform(0, 360)),
        "dec": float(rng.uniform(-30, 80)),
        "sgscore1": float(rng.uniform(0, 1)),
        "sgscore2": float(rng.uniform(0, 1)),
        "distpsnr1": float(rng.uniform(0, 10)),
        "distpsnr2": float(rng.uniform(0, 20)),
        "nmtchps": int(rng.integers(0, 10)),
        "sharpnr": float(rng.normal(0, 0.3)),
        "scorr": float(rng.uniform(5, 50)),
        "diffmaglim": float(rng.uniform(19, 21)),
        "sky": float(rng.normal(0, 1)),
        "ndethist": int(rng.integers(1, 100)),
        "ncovhist": int(rng.integers(100, 500)),
        "chinr": float(rng.uniform(0.5, 2.0)),
        "magnr": float(rng.uniform(15, 22)),
        "distnr": float(rng.uniform(0, 5)),
        "classtar": float(rng.uniform(0, 1)),
        "rb": float(rng.uniform(0.5, 1.0)),
        "chipsf": float(rng.uniform(0.5, 3.0)),
        "fwhm": float(rng.uniform(1.5, 4.0)),
    }
    if cls_idx is not None:
        # class-conditioned metadata shifts (learnable-corpus mode): the
        # AstroMiNN towers see sgscore/sharpnr/distnr distributions move
        cand["sgscore1"] = float(np.clip(rng.normal(0.15 + 0.18 * cls_idx, 0.08), 0, 1))
        cand["sharpnr"] = float(rng.normal((cls_idx - 2) * 0.25, 0.1))
        cand["distnr"] = float(abs(rng.normal(0.5 + 0.8 * cls_idx, 0.3)))
    stamps = {}
    for key in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
        if cls_idx is not None:
            img = _class_stamp(cls_idx, stamp_hw, rng, key)
        else:
            img = rng.normal(size=(stamp_hw, stamp_hw)).astype(np.float32)
        stamps[key] = {"stampData": write_fits_image(img, gzip_compress=True)}
    return {"candidate": cand, **stamps}


def make_object_dir(
    root: Path,
    obj_id: str,
    rng: np.random.Generator,
    n_photometry: int = 30,
    n_alerts: int = 8,
    with_spectrum: bool = True,
    stamp_hw: int = 63,
    cls_idx: int | None = None,
) -> None:
    """``cls_idx=None`` (default): class-independent noise, the golden-test
    fixture. With a class index, every modality carries that class's signal
    (light-curve template, spectral lines, cutout morphology, metadata
    shifts) — the learning-demo corpus."""
    obj_dir = Path(root) / obj_id
    obj_dir.mkdir(parents=True, exist_ok=True)

    jd0 = 2459000.5 + float(rng.uniform(0, 100))
    jds = np.sort(jd0 + rng.uniform(0, 60, size=n_photometry))
    fids = rng.integers(1, 3 + 1, size=n_photometry)
    if cls_idx is not None:
        t_rel = jds - jds[0]
        mags = _class_mag_curve(cls_idx, t_rel, rng)
        # small per-band color offset so band structure stays informative
        mags = mags + 0.1 * (fids - 2)
    else:
        mags = rng.uniform(16, 21, size=n_photometry)
    magerrs = rng.uniform(0.01, 0.3, size=n_photometry)
    lines = ["jd,mag,magerr,fid"]
    lines += [f"{jd:.6f},{m:.4f},{me:.4f},{f}" for jd, m, me, f in zip(jds, mags, magerrs, fids)]
    (obj_dir / "photometry.csv").write_text("\n".join(lines) + "\n")

    alert_jds = np.sort(rng.choice(jds, size=min(n_alerts, n_photometry), replace=False))
    alerts = [make_alert(rng, float(jd), int(rng.integers(1, 4)), stamp_hw,
                         cls_idx=cls_idx) for jd in alert_jds]
    np.save(obj_dir / "alerts.npy", np.asarray(alerts, dtype=object), allow_pickle=True)

    if with_spectrum:
        wl = np.linspace(4000, 8500, 300)
        if cls_idx is not None:
            flux = _class_spectrum(cls_idx, wl, rng)
        else:
            flux = 1e-16 * (1.0 + 0.3 * np.sin(wl / 200.0)) + rng.normal(0, 1e-18, size=len(wl))
        spec_lines = ["wavelength,flux,mjd"]
        spec_mjd = float(jds.mean() - 2400000.5)
        spec_lines += [f"{w:.2f},{f:.6e},{spec_mjd:.5f}" for w, f in zip(wl, flux)]
        (obj_dir / "spectra.csv").write_text("\n".join(spec_lines) + "\n")


def make_corpus(
    root: Path,
    n_objects: int = 10,
    seed: int = 0,
    classes=CLASS_NAMES,
    learnable: bool = False,
    class_weights=None,
    n_photometry: int | tuple[int, int] = 30,
    spectrum_frac: float | None = None,
    **object_kwargs,
) -> tuple[Path, Path]:
    """Create a synthetic raw corpus; returns (data_dir, labels_csv).

    ``learnable=True`` conditions every modality on the object's class
    (see ``make_object_dir``). Labels go round-robin over ``classes``, or
    with ``class_weights`` (e.g. ``BTS_CLASS_WEIGHTS``) are drawn from that
    distribution, the first ``len(classes)`` objects one of each class.

    Beyond the JAX package's ``make_corpus`` (which it equals, file for
    file, when neither is given): ``n_photometry`` may be an inclusive
    range ``(low, high)`` from which each object's count is drawn, and
    ``spectrum_frac`` gives each object a spectrum with that probability
    (drawn before the object) instead of ``with_spectrum`` for all.
    """
    rng = np.random.default_rng(seed)
    root = Path(root)
    data_dir = root / "raw"
    data_dir.mkdir(parents=True, exist_ok=True)
    if class_weights is not None:
        w = np.asarray(class_weights, np.float64)
        cls_ids = rng.choice(len(classes), size=n_objects, p=w / w.sum())
        cls_ids[: len(classes)] = np.arange(len(classes))  # at least one of each class
    else:
        cls_ids = np.arange(n_objects) % len(classes)
    rows = ["object_id,type"]
    for i in range(n_objects):
        obj_id = f"ZTFSYN{i:04d}"
        ci = int(cls_ids[i])
        kw = dict(object_kwargs)
        kw["n_photometry"] = (int(rng.integers(n_photometry[0], n_photometry[1] + 1))
                              if isinstance(n_photometry, tuple) else n_photometry)
        if spectrum_frac is not None:
            kw["with_spectrum"] = bool(rng.random() < spectrum_frac)
        make_object_dir(data_dir, obj_id, rng, cls_idx=ci if learnable else None, **kw)
        rows.append(f"{obj_id},{classes[ci]}")
    labels_csv = root / "labels.csv"
    labels_csv.write_text("\n".join(rows) + "\n")
    return data_dir, labels_csv
