"""The port's ``Trainer.fit`` == the JAX ``Trainer.fit`` under each training
option, on the same ``BaselineCLSTask`` and the same tiny
``PhotoEventsDataset``.

Each package reads the same manifests with its own dataset class; the JAX
task's flax init is both runs' ``init_params`` (carried by
``from_jax_params``); no shuffle, dropout 0, f32, 2 epochs (3 for the
plateau), the clip at 0.05 so that it binds. Compared: the final
parameters <= 1e-5 * max(1, |p|) (the attention's key bias, whose
gradient is zero but for rounding, within Adam's 2 * lr a step), every
``val_*`` metric <= 1e-5, the
epochs' ``last_grad_norm`` <= 1e-5 relative and ``lr_scale`` equal. With
``train.freeze_params`` the clip's norm covers the trainable gradients and
``grad_norm`` all of them, against the same norms of the JAX gradients. A
resume from ``last.pt`` carries the EMA shadow and the plateau state on;
a checkpoint without them still resumes.
"""

import jax
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.datasets.loader import DataLoader as JaxDataLoader
from applecider_tpu.datasets.photo_dataset import PhotoEventsDataset as JaxPhotoEventsDataset
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu.train.trainer import Trainer as JaxTrainer
from applecider_tpu.utils.observability import grad_norm as jax_grad_norm
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.datasets.photo_dataset import (
    COARSE_CLASSES, PhotoEventsDataset, compute_photo_feature_stats,
)
from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params

SEC = PhotoEventsDataset.SECTION
BATCH = 8  # divides the JAX trainer's 8-device CPU mesh
D_MODEL, LR = 16, 3e-3


def _write_manifest(root, name, n, seed, shift=0):
    """``n`` objects in the legacy photo_events npz layout (dt, dt_prev,
    band, logf, logfe) and their manifest, listed out of id order; object i
    has flux level i % 5 and label (i + shift) % 5."""
    rng = np.random.default_rng(seed)
    rows = ["object_id,filepath,label_str"]
    for i in rng.permutation(n):
        L = int(rng.integers(5, 40))
        dt = np.sort(rng.uniform(0, 150, L))
        data = np.stack([dt, np.diff(dt, prepend=0.0), rng.integers(0, 3, L),
                         rng.normal(3.0, 1.0, L) + (i % 5) * 0.3, rng.uniform(-2, 0, L)], axis=1)
        path = root / f"{name}_{i:03d}.npz"
        np.savez(path, data=data.astype(np.float32))
        rows.append(f"OBJ{name}{i:03d},{path},{COARSE_CLASSES[(i + shift) % 5]}")
    (root / f"{name}.csv").write_text("\n".join(rows) + "\n")
    return root / f"{name}.csv"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("photo")
    train = _write_manifest(root, "train", 24, 0)
    # labels the training signal does not predict: the validation loss
    # rises as the training loss falls, and the plateau scale drops
    val = _write_manifest(root, "val", 16, 1, shift=2)
    compute_photo_feature_stats(train, 100.0, root / "stats.npz")
    return {"train": train, "val": val, "stats": root / "stats.npz"}


def _overrides(data, manifest="train", **train):
    return {
        "model": {"name": "BaselineCLS", "BaselineCLS": {
            "d_model": D_MODEL, "n_heads": 2, "n_layers": 1, "dropout": 0.0, "lr": LR,
            "grad_clip": 0.05}},
        "data_set": {SEC: {"manifest_path": str(data[manifest]), "stats_path": str(data["stats"]),
                           "use_oversampling": False, "max_len": 48}},
        "train": {"compute_dtype": "float32", "seed": 0, "epochs": 2,
                  "early_stop_patience": 100, **train},
    }


def _cfgs(data, manifest="train", **train):
    over = _overrides(data, manifest, **train)
    return jax_load_defaults().merged_with(over), load_defaults().merged_with(over)


def _init_params(data):
    jcfg, _ = _cfgs(data)
    ds = JaxPhotoEventsDataset(jcfg)
    task = JaxBaselineCLSTask(jcfg)
    batch = task.to_tensor(ds.collate([ds.sample(i) for i in range(BATCH)]))
    return jax.tree.map(np.asarray, task.init(jax.random.PRNGKey(0), batch)["params"])


def _fit_both(data, tmp_path, epochs, **train):
    params = _init_params(data)
    (jcfg, cfg), (jvcfg, vcfg) = _cfgs(data, **train), _cfgs(data, "val", **train)
    jres = JaxTrainer(JaxBaselineCLSTask(jcfg), jcfg, tmp_path / "jax").fit(
        JaxDataLoader(JaxPhotoEventsDataset(jcfg), batch_size=BATCH, shuffle=False),
        JaxDataLoader(JaxPhotoEventsDataset(jvcfg), batch_size=BATCH, shuffle=False),
        epochs=epochs, init_params=params)
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, tmp_path / "port", device="cpu")
    res = trainer.fit(DataLoader(PhotoEventsDataset(cfg), batch_size=BATCH, shuffle=False),
                      DataLoader(PhotoEventsDataset(vcfg), batch_size=BATCH, shuffle=False),
                      epochs=epochs, init_params=from_jax_params(params))
    return jres, res, trainer


CASES = {  # options, epochs
    "freeze": ({"freeze_params": ["trunk"]}, 2),
    "accumulation": ({"grad_accum_steps": 2}, 2),
    "plateau": ({"plateau_factor": 0.5, "plateau_patience": 0}, 3),
    "ema": ({"ema_decay": 0.9}, 2),
    "remat": ({"remat": True}, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fit_matches_jax(data, tmp_path, case):
    train, epochs = CASES[case]
    jres, res, trainer = _fit_both(data, tmp_path, epochs, **train)
    want = from_jax_params(jax.tree.map(np.asarray, jres["state"].params))
    got = trainer.model.state_dict()
    assert got.keys() == want.keys()
    key_bias = slice(D_MODEL, 2 * D_MODEL)  # of each layer's fused q, k, v bias
    updates = trainer.optimizer.state_dict()["state"][0]["step"]
    for name, w in want.items():
        g, w = got[name].numpy().copy(), w.numpy().copy()
        if name.endswith("self_attn.in_proj.bias"):
            # attention is invariant to the key bias, so its gradient is 0 up
            # to rounding, which Adam's lr * g / (|g| + eps) turns into steps
            # of up to lr in a direction the two frameworks' roundings pick
            assert np.abs(g[key_bias] - w[key_bias]).max() <= 2 * LR * float(updates), name
            g[key_bias] = w[key_bias] = 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    assert len(res["history"]) == len(jres["history"]) == epochs
    for g, w in zip(res["history"], jres["history"]):
        vals = {k for k in w if k.startswith("val_")}
        assert vals == {k for k in g if k.startswith("val_")} and "val_accuracy" in vals
        for k in vals:
            assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])
        assert g["steps"] == w["steps"]
        assert abs(g["last_grad_norm"] - w["last_grad_norm"]) <= 1e-5 * w["last_grad_norm"]
        assert g.get("lr_scale") == w.get("lr_scale")
    assert res["best_metric"] == pytest.approx(jres["best_metric"], abs=1e-6)
    if case == "freeze":
        init = from_jax_params(_init_params(data))
        assert all(torch.equal(got[n], init[n]) for n in got if n.startswith("trunk."))
    if case == "plateau":
        assert [r["lr_scale"] for r in res["history"]][-1] < 1.0
    if case == "ema":  # the best checkpoint holds the shadow it was validated on
        best = torch.load(tmp_path / "port" / "checkpoints" / "best.pt", weights_only=True)
        last = torch.load(tmp_path / "port" / "checkpoints" / "last.pt", weights_only=True)
        assert any(not torch.equal(best["params"][n], last["params"][n]) for n in got)
        if res["history"][-1]["val_accuracy"] > res["history"][0]["val_accuracy"]:
            assert all(torch.equal(best["params"][n], last["ema"][n]) for n in got)


def test_freeze_clips_the_trainable_gradients(data, tmp_path):
    """With ``trunk`` frozen the clip sees the norm of the other gradients,
    and ``grad_norm`` is the norm of all of them, each <= 1e-5 relative to
    the JAX gradients' norms; the trunk's gradients are still computed."""
    params = _init_params(data)
    jcfg, cfg = _cfgs(data, freeze_params=["trunk"])
    jtask = JaxBaselineCLSTask(jcfg)
    host = JaxPhotoEventsDataset(jcfg)
    host_batch = host.collate([host.sample(i) for i in range(BATCH)])
    (_, _), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        params, jtask.to_tensor(host_batch), jax.random.PRNGKey(0), True)
    want_all = float(jax_grad_norm(grads))
    want_clip = float(jax_grad_norm({k: v for k, v in grads.items() if k != "trunk"}))

    norms = []
    for name in ("step", "clip"):
        task = BaselineCLSTask(cfg, device="cpu")
        task.module.load_state_dict(from_jax_params(params))
        trainer = Trainer(task, cfg, tmp_path / name, device="cpu")
        batch = trainer.to_device(task.to_tensor(host_batch))
        if name == "step":
            norms.append(float(trainer.train_step(batch)["grad_norm"]))
        else:
            loss, _ = task.loss(batch, train=True)
            loss.backward()
            assert all(p.grad is not None and p.requires_grad for p in task.module.parameters())
            norms.append(float(trainer.apply_gradients()))
    assert abs(norms[0] - want_all) <= 1e-5 * want_all
    assert abs(norms[1] - want_clip) <= 1e-5 * want_clip
    assert want_clip < want_all
    assert len(trainer.trainable) == sum(not n.startswith("trunk.")
                                         for n, _ in task.module.named_parameters())


def test_resume_carries_ema_and_plateau(data, tmp_path):
    """2 epochs, then a new Trainer resuming from ``last.pt`` to 3, equals 3
    epochs in one run: parameters, EMA shadow, plateau state, lr_scale.
    A ``last.pt`` without ``ema`` and ``plateau`` still resumes."""
    params = from_jax_params(_init_params(data))
    options = {"ema_decay": 0.9, "plateau_factor": 0.5, "plateau_patience": 0}
    cfg, vcfg = _cfgs(data, **options)[1], _cfgs(data, "val", **options)[1]

    def run(workdir, epochs):
        trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, workdir, device="cpu")
        res = trainer.fit(DataLoader(PhotoEventsDataset(cfg), batch_size=BATCH, shuffle=False),
                          DataLoader(PhotoEventsDataset(vcfg), batch_size=BATCH, shuffle=False),
                          epochs=epochs, init_params=params)
        return trainer, res

    whole, whole_res = run(tmp_path / "whole", 3)
    run(tmp_path / "split", 2)
    resumed, res = run(tmp_path / "split", 3)
    assert [r["epoch"] for r in res["history"]] == [2] and resumed.step == whole.step
    assert res["history"][0]["lr_scale"] == whole_res["history"][-1]["lr_scale"]
    assert (resumed.plateau.best, resumed.plateau.bad_epochs, resumed.plateau.scale) == \
        (whole.plateau.best, whole.plateau.bad_epochs, whole.plateau.scale)
    for name, p in whole.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[name], p, rtol=0, atol=1e-7)
        torch.testing.assert_close(resumed.ema.shadow[name], whole.ema.shadow[name], rtol=0,
                                   atol=1e-7)

    last = tmp_path / "split" / "checkpoints" / "last.pt"
    state = torch.load(last, weights_only=True)
    del state["ema"], state["plateau"]
    torch.save(state, last)
    legacy, res = run(tmp_path / "split", 4)
    assert [r["epoch"] for r in res["history"]] == [3]
    assert legacy.plateau.scale == res["history"][0]["lr_scale"] == 1.0
