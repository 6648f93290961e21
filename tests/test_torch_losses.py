"""The port's training criteria == ``applecider_tpu.ops.losses`` at atol
1e-6 and rtol 1e-6 (f32 log-softmax in both; the relative term is one f32
rounding of a summed loss of ~30): cross entropy with integer, soft and
weighted targets, and focal loss with gamma, alpha and label smoothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.ops import losses as jl
from applecider_tpu_torch.ops import losses as tl


@pytest.fixture
def data(rng):
    logits = (rng.normal(size=(16, 5)) * 3).astype(np.float32)
    labels = rng.integers(0, 5, size=16).astype(np.int64)
    soft = rng.dirichlet(np.ones(5), size=16).astype(np.float32)
    weight = rng.uniform(0.2, 3.0, size=5).astype(np.float32)
    return logits, labels, soft, weight


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_integer_labels(data, reduction, weighted):
    logits, labels, _, weight = data
    w = weight if weighted else None
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if w is None else torch.from_numpy(w), reduction)
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if w is None else jnp.asarray(w), reduction)
    _close(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_soft_targets(data, weighted):
    logits, _, soft, weight = data
    w = weight if weighted else None
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           None if w is None else torch.from_numpy(w))
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(soft),
                            None if w is None else jnp.asarray(w))
    _close(got, want)


@pytest.mark.parametrize("gamma,use_alpha,eps", [(2.0, False, 0.0), (0.5, True, 0.0),
                                                 (2.0, True, 0.1)])
def test_focal_loss(data, gamma, use_alpha, eps):
    logits, labels, _, weight = data
    alpha = weight if use_alpha else None
    got = tl.focal_loss(torch.from_numpy(logits), torch.from_numpy(labels), gamma,
                        None if alpha is None else torch.from_numpy(alpha), eps)
    want = jl.focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma,
                         None if alpha is None else jnp.asarray(alpha), eps)
    _close(got, want)


def test_cross_entropy_matches_torch(data):
    logits, labels, _, weight = data
    t = torch.from_numpy(logits)
    y = torch.from_numpy(labels)
    w = torch.from_numpy(weight)
    torch.testing.assert_close(tl.cross_entropy(t, y, w),
                               torch.nn.functional.cross_entropy(t, y, weight=w))
