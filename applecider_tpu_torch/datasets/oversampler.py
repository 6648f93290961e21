"""Oversampling index maps for class-imbalance correction (the port's copy
of ``applecider_tpu/datasets/oversampler.py``).

Behavioral contract from the reference
(``src/applecider/datasets/oversampler_mixin.py:27-157``): given an ideal
class distribution, find the minimal total count whose per-class targets
(largest-remainder integer rounding) are all >= current counts, then build
a shuffled map from oversampled index -> (original index, is_oversampled).

Divergence: the RNG is seeded (the reference draws from an unseeded
``default_rng``), so epochs are reproducible and resume-safe.
"""

from __future__ import annotations

import numpy as np


def oversampling_targets(ideal_distribution, class_counts) -> np.ndarray:
    """Minimal per-class target counts achieving the ideal distribution.

    Classes absent from the data (count 0) are dropped from the ideal
    distribution and the remaining mass renormalized — you can't oversample
    a class with no samples. (The reference crashes here:
    ``oversampler_mixin.py:125`` calls ``rng.choice`` on an empty pool, and
    its ``np.unique`` counts at ``:109`` silently misalign class indices
    when a class is missing. Both footguns fixed.)
    """
    p = np.asarray(ideal_distribution, dtype=np.float64)
    counts = np.asarray(class_counts, dtype=np.int64)
    p = np.where(counts > 0, p, 0.0)
    if p.sum() <= 0:
        return counts.copy()
    p = p / p.sum()

    required = np.zeros_like(counts)
    nonzero = p > 0
    required[nonzero] = np.ceil(counts[nonzero] / p[nonzero]).astype(np.int64)
    minimal_total = max(int(required.max(initial=0)), int(counts.sum()))

    real = p * minimal_total
    floor = np.floor(real).astype(np.int64)
    remainder = minimal_total - floor.sum()
    if remainder > 0:
        order = np.argsort(real - floor)[::-1]
        floor[order[:remainder]] += 1
    return floor


class Oversampler:
    """Shuffled oversampled-index -> original-index map."""

    def __init__(self, ideal_distribution, class_at_index, seed: int = 42):
        rng = np.random.default_rng(seed)
        class_at_index = np.asarray(class_at_index, dtype=np.int64)
        n_classes = len(ideal_distribution)
        # class -1 = "unknown target": ride through once (every original
        # index is always included) but never count toward nor replicate
        # for the balance — replicating a sample whose training target is
        # degenerate only amplifies it
        counts = np.bincount(
            class_at_index[class_at_index >= 0], minlength=n_classes
        )[:n_classes]
        targets = oversampling_targets(ideal_distribution, counts)
        self.additional_per_class = targets - counts
        # unknown-class rows still ride through once each
        self.total_count = int(targets.sum() + (class_at_index < 0).sum())

        original = np.arange(len(class_at_index))
        extra_idx = []
        for cls, extra in enumerate(self.additional_per_class):
            if extra <= 0:
                continue
            pool = np.where(class_at_index == cls)[0]
            extra_idx.append(rng.choice(pool, size=int(extra), replace=True))
        extras = np.concatenate(extra_idx) if extra_idx else np.empty(0, np.int64)
        index = np.concatenate([original, extras])
        flag = np.concatenate([np.zeros(len(original), bool), np.ones(len(extras), bool)])
        perm = rng.permutation(len(index))
        self._index = index[perm]
        self._is_oversampled = flag[perm]

    def __len__(self) -> int:
        return self.total_count

    def resolve(self, idx: int) -> tuple[int, bool]:
        """(original index, is_oversampled) for an oversampled index."""
        return int(self._index[idx]), bool(self._is_oversampled[idx])

    @property
    def index_map(self) -> np.ndarray:
        return self._index
