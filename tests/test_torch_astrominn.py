"""The port's AstroMiNN task == the JAX package's, on the CPU, in f32, at
``backbone_depths [1, 1]`` with the same weights (drawn by the port, norm
scales and biases perturbed, laid out as flax params and carried back by
``from_jax_params``):

* the module's logits <= 1e-4;
* the eval-mode loss (<= 1e-5), accuracy, and every gradient element by
  element (1e-5 * max(1, |g|));
* the 11 param groups: their members, lr, weight decay, betas and eps,
  frozen parameters left out and empty groups dropped;
* two AdamW steps over the groups, each side on its own gradients, against
  ``optax``: every parameter within 1e-5, except entries whose gradient is
  below 1e-6 (zero but for rounding, which eps 5e-10 amplifies to a step of
  up to lr in the direction the rounding picks), held within 2 * lr * steps;
* ``to_tensor``'s NCHW -> NHWC rule;
* ``AppleCiderRuntime("configs/astrominn.toml")`` on alert samples built by
  ``build_alert_samples`` from a ``preprocess_data`` corpus: 2 epochs with
  oversampling, then ``infer``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models import astrominn as jam
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.image_metadata_dataset import ImageAndMetadataDataset
from applecider_tpu_torch.models import astrominn as tam
from applecider_tpu_torch.preprocessing.alert_samples import build_alert_samples
from applecider_tpu_torch.preprocessing.cli import preprocess_data
from applecider_tpu_torch.testing import make_corpus
from applecider_tpu_torch.train.runtime import AppleCiderRuntime
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_pipeline import _flax_params
from tests.test_torch_spectranet import _perturbed_state

REPO = Path(__file__).resolve().parents[1]
WIDTHS = {"backbone_depths": [1, 1], "backbone_dims": [8, 16]}


def _cfgs(**settings):
    jcfg, cfg = jax_load_defaults(), load_defaults()
    for c in (jcfg, cfg):
        c.set("train.compute_dtype", "float32")
        for k, v in {**WIDTHS, **settings}.items():
            c.set(f"model.AstroMiNN.{k}", v)
    return jcfg, cfg


def _batch(seed: int, B: int = 8):
    """(metadata, NHWC images, one-hot targets)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 24)).astype(np.float32),
            rng.normal(size=(B, 63, 63, 3)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=B)])


@pytest.fixture(scope="module")
def pair():
    """(JAX task, flax params, a function giving a port task with them)."""
    jcfg, cfg = _cfgs()
    jtask = jam.AstroMiNNTask(jcfg)
    meta, img, _ = _batch(0)
    shapes = jax.eval_shape(lambda k: jtask.init(k, (meta, img)), jax.random.PRNGKey(0))
    state = _perturbed_state(tam.AstroMiNNTask(cfg, device="cpu").module, 11)
    params = _flax_params(shapes["params"], state)

    def port_task(**settings):
        task = tam.AstroMiNNTask(_cfgs(**settings)[1], device="cpu")
        task.module.load_state_dict(from_jax_params(params))
        return task

    return jtask, params, port_task


def test_module_logits_match_flax(pair):
    jtask, params, port_task = pair
    meta, img, _ = _batch(1)
    want = np.asarray(jax.jit(jtask.module.apply)({"params": params}, meta, img))
    with torch.no_grad():
        got = port_task().module.eval()(torch.from_numpy(meta), torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (8, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


_GRAD_FNS: dict = {}


def _jax_loss_and_grads(jtask, params, batch):
    """The JAX task's eval-mode (loss, accuracy) and gradients, one jitted
    function a task."""
    if id(jtask) not in _GRAD_FNS:
        def f(p, b):
            loss, aux = jtask.loss_fn(p, b, jax.random.PRNGKey(0), False)
            return loss, aux["metrics"]["accuracy"]

        _GRAD_FNS[id(jtask)] = jax.jit(jax.value_and_grad(f, has_aux=True))
    (loss, acc), grads = _GRAD_FNS[id(jtask)](params, batch)
    return float(loss), float(acc), grads


def test_loss_and_gradients_match_jax(pair):
    jtask, params, port_task = pair
    batch = _batch(2)
    want, want_acc, jgrads = _jax_loss_and_grads(jtask, params, batch)
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads))
    task = port_task()
    task.module.requires_grad_(True)
    loss, aux = task.loss(tuple(map(torch.from_numpy, batch)), train=False)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5, atol=1e-6)
    assert float(aux["metrics"]["accuracy"]) == want_acc
    for n, p in task.module.named_parameters():
        w = want_g[n]
        torch.testing.assert_close(p.grad, w, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())),
                                   msg=n)


def test_param_groups_follow_the_reference(pair):
    _, _, port_task = pair
    task = port_task()
    mc = task.mc
    opt = task.make_optimizer(list(task.module.parameters()))
    groups = {g["label"]: g for g in opt.param_groups}
    assert list(groups) == list(tam.GROUP_SETTINGS)
    names = {id(p): n for n, p in task.module.named_parameters()}
    for label, (lr_key, decay_key, betas_keys) in tam.GROUP_SETTINGS.items():
        g = groups[label]
        assert g["lr"] == pytest.approx(1.6e-4 * float(mc[lr_key]), rel=1e-12)
        assert g["weight_decay"] == float(mc[decay_key]) and g["eps"] == 5e-10
        assert g["betas"] == ((0.9, 0.999) if betas_keys is None else
                              (float(mc[betas_keys[0]]), float(mc[betas_keys[1]])))
        assert {tam.param_group_label(names[id(p)].split(".")[0]) for p in g["params"]} == {label}
    assert sum(len(g["params"]) for g in opt.param_groups) == len(names)
    assert groups["coord_tower"]["lr"] == groups["nst1_tower"]["lr"]
    # frozen parameters are left out; a group with none left is dropped
    trainable = [p for n, p in task.module.named_parameters() if not n.startswith("image_tower.")]
    labels = [g["label"] for g in task.make_optimizer(trainable).param_groups]
    assert labels == [lb for lb in tam.GROUP_SETTINGS if lb != "image_tower"]


def test_two_adamw_steps_match_optax(pair, tmp_path):
    jtask, params, port_task = pair
    tx = jtask.make_optimizer()
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    jparams = params
    task = port_task()
    trainer = Trainer(task, _cfgs()[1], tmp_path, device="cpu")
    lrs = {n: g["lr"] for g in trainer.optimizer.param_groups
           for n, p in task.module.named_parameters() if any(p is q for q in g["params"])}
    small = {}
    for step in range(2):
        batch = _batch(3 + step)
        _, _, jgrads = _jax_loss_and_grads(jtask, jparams, batch)
        updates, opt_state = update(jgrads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for n, g in from_jax_params(jax.tree.map(np.asarray, jgrads)).items():
            small[n] = small.get(n, torch.zeros_like(g, dtype=torch.bool)) | (g.abs() < 1e-6)
        task.module.zero_grad(set_to_none=True)
        loss, _ = task.loss(trainer.to_device(batch), train=False)
        loss.backward()
        trainer.apply_gradients()
    want = from_jax_params(jax.tree.map(np.asarray, jparams))
    worst, worst_small = 0.0, 0.0
    for n, p in task.module.named_parameters():
        d = (p.detach() - want[n]).abs()
        big = ~small[n]
        worst = max(worst, float(d[big].max()) if big.any() else 0.0)
        worst_small = max(worst_small, float(d[~big].max()) if (~big).any() else 0.0)
        assert bool((d[big] <= 1e-5).all()), n
        assert bool((d <= 2 * lrs[n] * 2 + 1e-7).all()), n
    print(f"two AdamW steps vs optax: max|dp| {worst:.3g} (<= 1e-5); where |g| < 1e-6 "
          f"{worst_small:.3g} (<= 2 * lr * 2)")


def test_to_tensor_turns_nchw_into_nhwc():
    rng = np.random.default_rng(0)
    for shape, nhwc in [((2, 3, 9, 9), (2, 9, 9, 3)), ((2, 9, 9, 3), (2, 9, 9, 3)),
                        ((2, 3, 9, 4), (2, 3, 9, 4))]:
        data = {"data": {"metadata": np.zeros((2, 24)), "image": rng.normal(size=shape),
                         "target": np.eye(5)[:2]}}
        got = tam.AstroMiNNTask.to_tensor(data)
        want = jam.AstroMiNNTask.to_tensor(data)
        assert got[1].shape == nhwc
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_runtime_trains_and_infers_astrominn_toml(tmp_path):
    raw, labels = make_corpus(tmp_path, n_objects=10, seed=4, n_photometry=12, n_alerts=3)
    preprocess_data(str(raw), str(labels), str(tmp_path / "out"), min_per_class=1, seed=42)
    index = build_alert_samples(tmp_path / "out" / "manifest_train.csv", tmp_path / "samples")
    overrides = {
        "model": {"AstroMiNN": WIDTHS},
        "train": {"compute_dtype": "float32", "epochs": 2},
        "data_loader": {"batch_size": 8, "drop_last": False},
        "model_inputs": {ph: {"data": {"data_location": str(tmp_path / "samples")}}
                         for ph in ("train", "infer")},
    }
    rt = AppleCiderRuntime(REPO / "configs" / "astrominn.toml", overrides,
                           workdir=tmp_path / "results", device="cpu")
    rt.prepare()
    ds = rt.datasets["train"]
    assert isinstance(ds, ImageAndMetadataDataset) and ds.oversampler is not None
    assert len(ds.records) == len(index) and len(ds) >= len(index)
    res = rt.train()
    assert [r["epoch"] for r in res["history"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in res["history"])
    preds = rt.infer()
    assert preds.shape == (len(ds), 5) and np.isfinite(preds).all()
