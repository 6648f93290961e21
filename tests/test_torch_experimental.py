"""The port's ``models/experimental.py`` and ``utils/plots.py`` against the
JAX package's on the CPU: the positional encodings, the soft centroid and
``CNNTower`` (weights carried by ``from_jax_params``) within 1e-5 in
f32, and the four evaluation plots written, their curve points equal to
the JAX helpers'."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.models import experimental as jexp
from applecider_tpu.utils import plots as jplots
from applecider_tpu_torch.models import experimental
from applecider_tpu_torch.models.layers import init_weights
from applecider_tpu_torch.utils import plots
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_zoo import _carried

TOL = 1e-5


def test_position_embedding_sine_matches_jax():
    for h, w, dim in ((8, 8, 16), (5, 9, 12)):
        np.testing.assert_allclose(experimental.position_embedding_sine(h, w, dim).numpy(),
                                   np.asarray(jexp.position_embedding_sine(h, w, dim)),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="divisible by 4"):
        experimental.position_embedding_sine(4, 4, 6)


@pytest.mark.parametrize("kind", ["sine", "learned", "fourier"])
def test_position_embedding_matches_jax(kind):
    x = np.random.default_rng(1).normal(size=(2, 6, 7, 16)).astype(np.float32)
    m = jexp.PositionEmbedding(16, kind)
    variables = m.init(jax.random.PRNGKey(0), x)
    port = experimental.PositionEmbedding((6, 7), dim=16, kind=kind)
    port.load_state_dict(from_jax_params(variables.get("params", {})), strict=True)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(),
                                   np.asarray(m.apply(variables, x)), rtol=TOL, atol=TOL)


def test_soft_centroid_matches_jax():
    attn = np.random.default_rng(2).normal(size=(3, 9, 7)).astype(np.float32) * 3
    attn[0] = -10.0
    attn[0, 2, 6] = 20.0
    got = experimental.soft_centroid(torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got, np.asarray(jexp.soft_centroid(jnp.asarray(attn))),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[0], [2.0, 6.0], atol=0.05)


@pytest.mark.parametrize("pos_kind", ["sine", "learned"])
def test_cnn_tower_matches_jax(pos_kind):
    m = jexp.CNNTower(channels=8, depth=2, outdims=16, pos_kind=pos_kind, dtype=jnp.float32)
    x = np.random.default_rng(3).normal(size=(2, 20, 20, 3)).astype(np.float32)
    port = init_weights(experimental.CNNTower((20, 20, 3), channels=8, depth=2, outdims=16,
                                              pos_kind=pos_kind, dtype=torch.float32),
                        torch.Generator().manual_seed(0))
    params, _ = _carried(m, port, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(m.apply)({"params": params}, x)),
                               rtol=TOL, atol=TOL)
    assert got.shape == (2, 16) and got.dtype == np.float32


def test_plots_write_their_files_from_the_jax_points(tmp_path):
    rng = np.random.default_rng(42)
    classes = ["SN I", "SN II", "CV", "AGN", "TDE"]
    labels = rng.integers(0, 5, size=100)
    logits = rng.normal(size=(100, 5)) + 2.0 * np.eye(5)[labels]
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for c in range(5):
        pos = labels == c
        for port_fn, jax_fn in ((plots._roc_points, jplots._roc_points),
                                (plots._pr_points, jplots._pr_points)):
            for a, b in zip(port_fn(probs[:, c], pos), jax_fn(probs[:, c], pos)):
                np.testing.assert_array_equal(a, b)
    plots.plot_confusion_matrix(probs.argmax(1), labels, classes, save_path=tmp_path / "cm.png")
    plots.plot_roc_curves(probs, labels, classes, save_path=tmp_path / "roc.png")
    plots.plot_pr_curves(probs, labels, classes, save_path=tmp_path / "pr.png")
    plots.plot_redshift_scatter(rng.uniform(0, 1, 50), rng.uniform(0, 1, 50),
                                save_path=tmp_path / "z.png")
    for f in ("cm.png", "roc.png", "pr.png", "z.png"):
        assert (tmp_path / f).stat().st_size > 0
