"""The traffic generator: one function per traffic ``kind``'s samples,
driven by a mix file's parameters and the run's seed.

The per-alert and per-sample distributions are those of the program's own
synthetic data (``make_alert_samples`` and ``SyntheticFusionDataset``),
copied here so that the yardstick does not move with the program. Sizes are
stratified: every seed gets the same multiset of light-curve lengths,
spectrum presences and spectrum lengths, in its own order, so that seeds
change the values and the order and not the amount of work.
"""

from __future__ import annotations

import numpy as np


def stratified(n: int, lo: int, hi: int) -> np.ndarray:
    """n integers spread evenly over [lo, hi] (inclusive)."""
    return lo + ((np.arange(n) + 0.5) * (hi - lo + 1) / n).astype(np.int64)


def alert_pool(p: dict, seed: int) -> list[dict]:
    """``p["pool"]`` alerts in the serving path's sample layout: a
    time-ascending light curve of ``p["length"]`` points over ``p["days"]``
    days, a 63x63x3 stamp triplet, 19 metadata values and, on a
    ``p["spectrum_frac"]`` share of them, a raw spectrum of
    ``p["spectrum_points"]`` points."""
    n = int(p["pool"])
    rng = np.random.default_rng([int(seed), 1])
    lengths = rng.permutation(stratified(n, *p["length"]))
    n_spec = int(round(n * float(p["spectrum_frac"])))
    spec_len = np.zeros(n, np.int64)
    spec_len[rng.permutation(n)[:n_spec]] = rng.permutation(
        stratified(n_spec, *p["spectrum_points"]))
    hw = int(p.get("stamp", 63))
    images = rng.standard_normal((n, hw, hw, 3), dtype=np.float32)
    meta = rng.standard_normal((n, 19), dtype=np.float32)
    total = int(lengths.sum())
    t = rng.uniform(0.0, float(p["days"]), total).astype(np.float32)
    flux = rng.lognormal(2.0, 1.0, total).astype(np.float32)
    err = (0.05 * flux + rng.uniform(0.1, 2.0, total)).astype(np.float32)
    band = rng.integers(0, 3, total).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    alerts = []
    for i in range(n):
        sl = slice(starts[i], starts[i] + lengths[i])
        a = {"photo_t": np.sort(t[sl]), "photo_flux": flux[sl], "photo_err": err[sl],
             "photo_band": band[sl], "image": images[i], "meta19": meta[i]}
        if spec_len[i]:
            m = int(spec_len[i])
            a["spec_wl"] = np.linspace(4000.0, 8500.0, m).astype(np.float32)
            a["spec_flux"] = rng.normal(1.0, 0.3, m).astype(np.float32)
        alerts.append(a)
    return alerts


class FusionSamples:
    """Training samples of the fused model in the program's data-set
    interface (``sample``/``collate``): ``photometry`` (P, 7) of P in
    ``length`` events (four continuous channels, then a one-hot band),
    ``metadata`` (24,), ``image`` (63, 63, 3), ``spectrum`` (bins,),
    ``label`` in [0, classes), the photometry ``mean``/``std``. Sample i is
    drawn from a generator seeded by (seed, i); ``index`` says which."""

    def __init__(self, p: dict, seed: int):
        self.n, self.seed = int(p["samples"]), int(seed)
        self.lo, self.max_len = p["length"]
        self.bins, self.classes = int(p["bins"]), int(p["classes"])
        self.mean = np.asarray(p["mean"], np.float32)
        self.std = np.asarray(p["std"], np.float32)

    def __len__(self) -> int:
        return self.n

    def sample(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, int(idx)))
        P = int(rng.integers(self.lo, self.max_len + 1))
        vec4 = rng.standard_normal((P, 4), dtype=np.float32) * self.std + self.mean
        band = np.eye(3, dtype=np.float32)[rng.integers(0, 3, P)]
        return {
            "photometry": np.concatenate([vec4, band], axis=1),
            "metadata": rng.standard_normal(24, dtype=np.float32),
            "image": rng.standard_normal((63, 63, 3), dtype=np.float32),
            "spectrum": rng.standard_normal(self.bins, dtype=np.float32),
            "label": int(rng.integers(0, self.classes)),
            "mean": self.mean, "std": self.std, "index": int(idx),
        }

    def collate(self, samples: list[dict]) -> dict:
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
            "index": np.asarray([s["index"] for s in samples], np.int64),
        }}


class SpectraSamples:
    """Training samples of a spectra classifier: ``flux`` (bins,) standard
    normal and ``label`` in [0, classes), from a generator seeded by
    (seed, i)."""

    def __init__(self, p: dict, seed: int):
        self.n, self.seed = int(p["samples"]), int(seed)
        self.bins, self.classes = int(p["bins"]), int(p["classes"])
        self.max_len = self.bins

    def __len__(self) -> int:
        return self.n

    def sample(self, idx: int) -> dict:
        rng = np.random.default_rng((self.seed, int(idx)))
        return {"flux": rng.standard_normal(self.bins, dtype=np.float32),
                "label": int(rng.integers(0, self.classes)), "index": int(idx)}

    def collate(self, samples: list[dict]) -> dict:
        return {"data": {
            "flux": np.stack([s["flux"] for s in samples]),
            "label": np.asarray([s["label"] for s in samples], np.int64),
            "index": np.asarray([s["index"] for s in samples], np.int64),
        }}


class Pooled:
    """A training set of ``p["samples"]`` samples made once, in set-up, by
    the generator of ``p["samples_of"]``: the loader's producer thread then
    only looks samples up and collates them, and does not draw them under
    the interpreter lock while the step launches its kernels."""

    def __init__(self, source, n: int):
        self.source, self.max_len = source, source.max_len
        self.samples = [source.sample(i) for i in range(n)]

    def __len__(self) -> int:
        return len(self.samples)

    def sample(self, idx: int) -> dict:
        return self.samples[int(idx)]

    def collate(self, samples: list[dict]) -> dict:
        return self.source.collate(samples)

    def points(self, idx: int) -> int:
        s = self.samples[int(idx)]
        return len(s["photometry"]) if "photometry" in s else self.max_len


SAMPLES = {"fusion": FusionSamples, "spectra": SpectraSamples}


def training_samples(p: dict, seed: int) -> Pooled:
    return Pooled(SAMPLES[p["samples_of"]](p, seed), int(p["samples"]))
