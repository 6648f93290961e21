"""Synthetic data for the port's smoke test and tests, drawn from NumPy
generators seeded by ``seed``.

* ``make_alert_samples``: raw alerts in ``pack_alert_batch``'s contract, a
  time-ascending light curve (``photo_t``/``photo_flux``/``photo_err``/
  ``photo_band``), a 63x63x3 cutout ``image``, ``meta19`` and, for a
  ``spectrum_frac`` share of the alerts, a raw spectrum
  (``spec_wl``/``spec_flux``);
* ``SyntheticFusionDataset``: featurised training samples in
  ``FusionDataset``'s ``sample``/``collate`` contract.
"""

from __future__ import annotations

import numpy as np


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
