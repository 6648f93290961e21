"""The port's training step == the JAX package's, at small widths.

``_fusion_task(tiny=True)`` in f32 with direct convs, the JAX weights
carried over by ``from_jax_params``. The JAX step draws AstroMiNN's dropout
masks from jax.random at rates the flax modules hard-code, which the port
cannot reproduce, so the step is held in its deterministic form:
``jax.value_and_grad(task.loss_fn)(params, batch, rng, False)`` against the
port's model in ``eval()`` mode with autograd on (which routes the
attention through K4's plain version at rate 0). Tolerances: loss atol
1e-5; each gradient atol 1e-5 + 1e-4 * max|g| (two frameworks reorder f32
sums); after one clipped Adam step, parameters within 1e-6 where
|g_jax| >= 1e-5 and within 2 * lr + 1e-7 elsewhere (Adam's first step is
lr * g / (|g| + 1e-8), so a near-zero gradient whose sign differs between
the frameworks moves its parameter by up to 2 * lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from __graft_entry__ import _fusion_task
from applecider_tpu.train.optim import with_grad_clip
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.models.fusion import AppleCiderTask, fusion_loss
from applecider_tpu_torch.testing import SyntheticFusionDataset
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params

TINY = [
    ("model.BaselineCLS.d_model", 16), ("model.BaselineCLS.n_heads", 2),
    ("model.BaselineCLS.n_layers", 1), ("model.SpectraNet.channels", [4, 8]),
    ("model.SpectraNet.depths", [1, 1]),
    ("model.SpectraNet.kernel_sizes_per_stage", [[3, 7], [3, 5]]),
    ("model.AstroMiNN.backbone_depths", [1, 1]), ("model.AstroMiNN.backbone_dims", [8, 16]),
    ("train.compute_dtype", "float32"),
]
B, SEQ, BINS = 4, 32, 128


def _port_cfg(**extra):
    cfg = load_defaults()
    for k, v in TINY + list(extra.items()):
        cfg.set(k, v)
    return cfg


def _batch():
    """A fusion batch of ``_fusion_batch(tiny=True)``'s shapes, with ragged
    light curves."""
    rng = np.random.default_rng(3)
    photometry = rng.normal(size=(B, SEQ, 7)).astype(np.float32)
    pad_mask = np.arange(SEQ)[None, :] >= np.array([SEQ, 20, 9, 27])[:, None]
    metadata = rng.normal(size=(B, 24)).astype(np.float32)
    images = rng.normal(size=(B, 63, 63, 3)).astype(np.float32)
    spectra = rng.normal(size=(B, BINS)).astype(np.float32)
    labels = np.array([0, 3, 1, 4], np.int64)
    return (photometry, pad_mask, metadata, images, spectra, labels)


@pytest.fixture(scope="module", params=["ce", "focal"])
def jax_step(request):
    """JAX's deterministic loss, gradients and one clipped Adam step."""
    cfg = _fusion_task(tiny=True, compute_dtype="float32").config
    cfg.set("model.SpectraNet.conv_mode", "direct")
    cfg.set("model.AppleCider.criterion", request.param)
    from applecider_tpu.models.fusion import AppleCiderTask

    task = AppleCiderTask(cfg)
    batch = _batch()
    jbatch = tuple(jnp.asarray(a) for a in batch)
    params = jax.jit(lambda r: task.init(r, batch)["params"])(jax.random.PRNGKey(0))
    tx = with_grad_clip(task.make_optimizer(), task.grad_clip)

    @jax.jit
    def step(params, jbatch):
        (loss, aux), grads = jax.value_and_grad(task.loss_fn, has_aux=True)(
            params, jbatch, jax.random.PRNGKey(1), False)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, aux["metrics"]["accuracy"], grads, optax.apply_updates(params, updates)

    loss, acc, grads, new_params = step(params, jbatch)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"criterion": request.param, "batch": batch, "params": to_np(params),
            "loss": float(loss), "acc": float(acc),
            "grads": to_np(grads), "new_params": to_np(new_params), "lr": 1e-4}


def _port_step(jax_step, tmp_path):
    """The port's model with JAX's weights, in eval mode with autograd on:
    loss, accuracy, gradients by name, then one clipped Adam step."""
    cfg = _port_cfg(**{"model.AppleCider.criterion": jax_step["criterion"]})
    model = build_fusion_model(cfg, device="cpu")
    model.load_state_dict(from_jax_params(jax_step["params"]))
    trainer = Trainer(AppleCiderTask(cfg, model), cfg, tmp_path, device="cpu", seed=0)
    batch = trainer.to_device(jax_step["batch"])
    model.zero_grad(set_to_none=True)
    loss, aux = trainer.task.loss(batch, train=False)
    acc = aux["metrics"]["accuracy"]
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    trainer.apply_gradients()
    return trainer, float(loss.detach()), float(acc), grads


def test_loss_and_gradients_match_jax(jax_step, tmp_path):
    _, loss, acc, grads = _port_step(jax_step, tmp_path)
    assert abs(loss - jax_step["loss"]) <= 1e-5
    assert acc == jax_step["acc"]
    want = from_jax_params(jax_step["grads"])  # a gradient tree maps as the params do
    assert set(want) == set(grads)
    for name, g in want.items():
        g = g.numpy()
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                   atol=1e-5 + 1e-4 * float(np.abs(g).max()), err_msg=name)


def test_one_adam_step_matches_optax(jax_step, tmp_path):
    trainer, _, _, _ = _port_step(jax_step, tmp_path)
    want = from_jax_params(jax_step["new_params"])
    g_jax = from_jax_params(jax_step["grads"])
    bound = 2 * jax_step["lr"] + 1e-7
    for name, p in trainer.model.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        big = np.abs(g_jax[name].numpy()) >= 1e-5
        assert (d[big] <= 1e-6).all(), (name, float(d[big].max()))
        assert (d <= bound).all(), (name, float(d.max()))


def test_fusion_loss_criteria():
    """``criterion`` picks focal loss (with ``focal_gamma``) or cross entropy."""
    logits = torch.tensor([[2.0, 0.5, -1.0], [0.1, 0.2, 0.3]])
    labels = torch.tensor([0, 1])
    ce, acc = fusion_loss(logits, labels, _port_cfg())
    assert torch.isclose(ce, torch.nn.functional.cross_entropy(logits, labels))
    assert float(acc) == 0.5
    focal, _ = fusion_loss(logits, labels, _port_cfg(**{"model.AppleCider.criterion": "focal",
                                                        "model.AppleCider.focal_gamma": 0.0}))
    assert torch.isclose(focal, ce)  # gamma 0 is cross entropy


def test_fit_writes_metrics_and_checkpoint_and_resumes(tmp_path):
    """Two epochs with dropout live write two metrics records and the
    checkpoints; a second fit with a larger budget resumes at epoch 2."""
    cfg = _port_cfg(**{"model.BaselineCLS.dropout": 0.4, "train.early_stop_patience": 5})
    data = SyntheticFusionDataset(8, seed=1, max_len=SEQ, spec_bins=BINS)
    loader = DataLoader(data, batch_size=4, seed=0, drop_last=True, prefetch=1)
    model = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    out = Trainer(AppleCiderTask(cfg, model), cfg, tmp_path, device="cpu", seed=0).fit(
        loader, loader, epochs=2)
    assert [r["epoch"] for r in out["history"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and r["steps"] == 2 * (r["epoch"] + 1)
               for r in out["history"])
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters())
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and "val_accuracy" in lines[0]
    assert (tmp_path / "checkpoints" / "last.pt").exists()
    assert (tmp_path / "checkpoints" / "best.pt").exists()

    model2 = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    trainer2 = Trainer(AppleCiderTask(cfg, model2), cfg, tmp_path, device="cpu", seed=0)
    again = trainer2.fit(loader, epochs=3)
    assert [r["epoch"] for r in again["history"]] == [2]
    assert trainer2.step == 6
    last = torch.load(tmp_path / "checkpoints" / "last.pt", weights_only=True)
    assert last["epoch"] == 2 and last["step"] == 6


def test_train_step_draws_new_masks_each_step(tmp_path):
    """Dropout is live in train mode and two steps draw different masks:
    the same batch and weights give different losses in two steps."""
    cfg = _port_cfg(**{"model.BaselineCLS.dropout": 0.4, "model.AppleCider.lr": 0.0})
    model = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(AppleCiderTask(cfg, model), cfg, tmp_path, device="cpu", seed=0)
    batch = trainer.to_device(_batch())
    a = trainer.train_step(batch)
    b = trainer.train_step(batch)  # lr 0: same weights
    assert set(a) == {"loss", "accuracy", "grad_norm"}
    assert float(a["loss"]) != float(b["loss"])
    with torch.no_grad():
        e1, _ = trainer.task.loss(batch, train=False)
        e2, _ = trainer.task.loss(batch, train=False)
    assert float(e1) == float(e2)  # eval is deterministic
