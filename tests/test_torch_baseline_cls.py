"""The port's BaselineCLS classifier task == the JAX package's, at small
widths in f32 with dropout 0, on the same NumPy-seeded batches and the JAX
task's flax weights carried by ``from_jax_params``: logits <= 1e-4 (through
K2's plain version without autograd and K4's at rate 0 with it), the focal
loss <= 1e-5 and its TDE count, ``to_tensor`` exactly, and ``predict``
with and without ``use_probabilities`` <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
from applecider_tpu_torch.utils.weights import from_jax_params

WIDTHS = {"d_model": 32, "n_heads": 4, "n_layers": 1, "dropout": 0.0}


def _cfgs(**extra):
    jcfg, cfg = jax_load_defaults(), load_defaults()
    for c in (jcfg, cfg):
        for k, v in {**WIDTHS, **extra}.items():
            c.set(f"model.BaselineCLS.{k}", v)
        c.set("train.compute_dtype", "float32")
    return jcfg, cfg


def _host_batch(seed=0, B=8, L=30):
    """A collated PhotoEventsDataset batch: raw channels, ragged lengths,
    the train stats and labels with TDEs among them."""
    rng = np.random.default_rng(seed)
    photometry = np.zeros((B, L, 7), np.float32)
    lengths = rng.integers(3, L + 1, size=B)
    pad = np.arange(L)[None, :] >= lengths[:, None]
    for i, n in enumerate(lengths):
        photometry[i, :n, :4] = rng.normal(2.0, 1.5, size=(n, 4))
        photometry[i, np.arange(n), 4 + rng.integers(0, 3, size=n)] = 1.0
    return {"data": {"photometry": photometry, "pad_mask": pad,
                     "mean": rng.normal(size=4).astype(np.float32),
                     "std": rng.uniform(0.5, 2.0, size=4).astype(np.float32),
                     "label": np.array([0, 4, 1, 4, 2, 3, 4, 0][:B], np.int64)}}


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = _cfgs()
    jtask = JaxBaselineCLSTask(jcfg)
    batch = jtask.to_tensor(_host_batch())
    params = jax.tree.map(np.asarray, jtask.init(jax.random.PRNGKey(2), batch)["params"])
    task = BaselineCLSTask(cfg, device="cpu")
    task.module.load_state_dict(from_jax_params(params))
    return jtask, params, task


def _tensors(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def test_to_tensor_matches_jax():
    host = _host_batch(1)
    want = JaxBaselineCLSTask.to_tensor(host)
    got = BaselineCLSTask.to_tensor(host)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    no_mask = {"data": {k: v for k, v in host["data"].items() if k != "pad_mask"}}
    assert not BaselineCLSTask.to_tensor(no_mask)[1].any()


@pytest.mark.parametrize("autograd", [False, True])
def test_logits_match_jax(pair, autograd):
    jtask, params, task = pair
    batch = jtask.to_tensor(_host_batch(2))
    want = jtask.module.apply({"params": params}, jnp.asarray(batch[0]), jnp.asarray(batch[1]),
                              deterministic=True)
    task.module.eval()
    with torch.set_grad_enabled(autograd):
        got = task.module(*_tensors(batch[:2]))
    assert got.dtype == torch.float32 and got.shape == (8, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("gamma", [2.0, 0.5])
def test_focal_loss_matches_jax(gamma):
    jcfg, cfg = _cfgs(focal_gamma=gamma)
    jtask = JaxBaselineCLSTask(jcfg)
    batch = jtask.to_tensor(_host_batch(3))
    params = jax.tree.map(np.asarray, jtask.init(jax.random.PRNGKey(4), batch)["params"])
    loss, aux = jtask.loss_fn(params, tuple(jnp.asarray(a) for a in batch),
                              jax.random.PRNGKey(0), False)
    task = BaselineCLSTask(cfg, device="cpu")
    task.module.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got, got_aux = task.loss(_tensors(batch), train=False)
    assert abs(float(got) - float(loss)) <= 1e-5
    assert int(got_aux["metrics"]["num_tdes"]) == int(aux["metrics"]["num_tdes"]) == 3
    np.testing.assert_allclose(got_aux["logits"].numpy(), np.asarray(aux["logits"]), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("probabilities", [False, True])
def test_predict_matches_jax(pair, probabilities):
    jtask, params, task = pair
    batch = jtask.to_tensor(_host_batch(4))
    jtask.mc["use_probabilities"] = task.mc["use_probabilities"] = probabilities
    try:
        want = np.asarray(jtask.predict(params, tuple(jnp.asarray(a) for a in batch)))
        with torch.no_grad():
            got = task.predict(_tensors(batch)).numpy()
    finally:
        jtask.mc["use_probabilities"] = task.mc["use_probabilities"] = False
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if probabilities:
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_embedding_mode_has_no_head():
    """``mode`` other than "photo" is the fusion model's embedding: the
    normalised CLS token, (B, d_model), and no ``fc`` weights."""
    _, cfg = _cfgs(mode="embed")
    task = BaselineCLSTask(cfg, device="cpu")
    assert not any(n.startswith("fc.") for n in task.module.state_dict())
    with torch.no_grad():
        out = task.module(*_tensors(BaselineCLSTask.to_tensor(_host_batch())[:2]))
    assert out.shape == (8, WIDTHS["d_model"])
