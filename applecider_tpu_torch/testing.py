"""Synthetic alert samples for the port's smoke test and tests.

Each sample follows ``pack_alert_batch``'s contract: a time-ascending light
curve (``photo_t``/``photo_flux``/``photo_err``/``photo_band``), a 63x63x3
cutout ``image``, ``meta19`` and, for a ``spectrum_frac`` share of the
alerts, a raw spectrum (``spec_wl``/``spec_flux``). Everything is drawn from
a NumPy generator seeded by ``seed``.
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
