"""The port's copy of the metric suite == the JAX package's ``ops/metrics``,
to 1e-12, on random probabilities and labels (with ties, missing classes
and a single class), and on a per-alert serving output."""

import numpy as np
import pytest

from applecider_tpu.ops import metrics as jax_metrics
from applecider_tpu_torch.ops import metrics


def _same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (np.ndarray, list)):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=0, atol=1e-12)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert abs(got - want) <= 1e-12, (got, want)


@pytest.mark.parametrize("case", ["random", "ties", "missing_class", "one_class"])
def test_classification_report_matches_jax(case):
    rng = np.random.default_rng(["random", "ties", "missing_class", "one_class"].index(case))
    n, c = 200, 5
    probs = rng.dirichlet(np.ones(c), size=n)
    labels = rng.integers(0, c, size=n)
    if case == "ties":
        probs = np.round(probs, 1)
    elif case == "missing_class":
        labels[labels == 3] = 1
    elif case == "one_class":
        labels[:] = 2
    got = metrics.classification_report(probs, labels)
    want = jax_metrics.classification_report(probs, labels)
    _same(got, want)
    assert got["confusion_matrix"].dtype == want["confusion_matrix"].dtype


def test_regression_and_early_reports_match_jax():
    rng = np.random.default_rng(7)
    z = rng.uniform(0, 0.2, 50)
    pred = z + rng.normal(0, 0.05, 50)
    _same(metrics.redshift_metrics(pred, z), jax_metrics.redshift_metrics(pred, z))
    labels = rng.integers(0, 5, 40)
    _same(metrics.dirichlet_random_pr_auc_baseline(labels, 5, n_trials=20),
          jax_metrics.dirichlet_random_pr_auc_baseline(labels, 5, n_trials=20))
    results = [{"object_id": f"o{i % 7}", "jd": float(i), "probs": rng.dirichlet(np.ones(5))}
               for i in range(30)]
    by_object = {f"o{i}": int(i % 5) for i in range(7)}
    _same(metrics.early_classification_report(results, by_object),
          jax_metrics.early_classification_report(results, by_object))
