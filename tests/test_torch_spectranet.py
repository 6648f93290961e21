"""The port's spectra family == the JAX package's, on the CPU, in f32 with
direct convolutions on the JAX side (its auto-router would take the FFT
path):

* the three pools exactly in f32, the average in bf16 within
  2e-2 * max(1, |ref|);
* ``SpectraNetModule`` as classifier, redshift regressor (with and without
  softplus) and embedding, and ``SpectraNetTriPoolModule`` with LayerNorm
  and with frozen BatchNorm stages, alone and inside the fusion model,
  outputs <= 1e-4 with the same weights (drawn by the port, every norm's
  scale and bias and the BatchNorm statistics perturbed, laid out as flax
  ``params`` and ``batch_stats`` and carried back by ``from_jax_params``);
* each task's eval-mode loss (<= 1e-5) and gradients: the stage
  parameters, whose gradients pass a max or min pool, in norm (||dg|| <=
  1e-3 ||g||: a nearly tied window can send its gradient to another
  argmax), the head's element by element (1e-5 * max(1, |g|));
* a training step leaves the frozen BatchNorm statistics bit for bit;
* ``Trainer.evaluate`` of the classifier gives the JAX trainer's report:
  both score the predictions against the batch's last tensor, the
  redshifts (a reference quirk, kept);
* ``FusedSpectraStream`` with the TriPool encoder equals the monolithic
  pipeline (<= 1e-5);
* ``AppleCiderRuntime`` trains ``configs/spectra.toml`` (classifier,
  redshift, TriPool) for 2 epochs and infers.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models import spectranet as jsn
from applecider_tpu.models.fusion import AppleCiderTask as JaxAppleCiderTask
from applecider_tpu.ops import conv1d as jconv
from applecider_tpu.train.trainer import Trainer as JaxTrainer
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.spectra_dataset import LABEL_STRINGS, SpectraDataset
from applecider_tpu_torch.infer import stream as ts
from applecider_tpu_torch.models import build_fusion_model, spectranet as tsn
from applecider_tpu_torch.models.layers import init_weights
from applecider_tpu_torch.ops import conv1d as tconv
from applecider_tpu_torch.testing import make_alert_samples
from applecider_tpu_torch.train.runtime import AppleCiderRuntime
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_pipeline import TINY, _flax_params

REPO = Path(__file__).resolve().parents[1]
SPECTRA_SECTION = SpectraDataset.SECTION
L = 64
CHANNELS, KERNELS = [4, 8], [[3, 7], [3, 5]]
TRI_CHANNELS, TRI_KERNELS = [2, 4, 4], [[3, 7], [3, 5], [3]]
USE_LN = {"ln": (True, True, True), "bn": (False, False, True)}


def _perturbed_state(module: torch.nn.Module, seed: int) -> dict:
    """The port's weights drawn from ``seed``, every norm's scale and bias
    and every BatchNorm statistic moved off its init."""
    init_weights(module, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "norm" in name:
                p.add_(0.2 * torch.randn(p.shape, generator=g))
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5)
    return module.state_dict()


def _flax_stats(shapes, state: dict, prefix=()) -> dict:
    """The port's BatchNorm buffers laid out as flax ``batch_stats``."""
    out = {}
    for key, leaf in shapes.items():
        if isinstance(leaf, dict):
            out[key] = _flax_stats(leaf, state, (*prefix, key))
        else:
            out[key] = state[".".join((*prefix, f"running_{key}"))].numpy()
    return out


def _carry(jax_variables_shapes, state: dict):
    """(flax params, flax batch_stats or None, the port's state_dict back
    from them)."""
    params = _flax_params(jax_variables_shapes["params"], state)
    stats = None
    if "batch_stats" in jax_variables_shapes:
        stats = _flax_stats(jax_variables_shapes["batch_stats"], state)
    return params, stats, from_jax_params(params, stats)


def _spectra(seed: int, B: int = 5, length: int = L) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, length)).astype(np.float32)


# ------------------------------------------------------------------ pools
@pytest.mark.parametrize("pool", ["max", "avg", "min"])
def test_pools_match_jax_exactly_in_f32(rng, pool):
    x = rng.normal(size=(3, 37, 5)).astype(np.float32)  # 37: a ragged tail of 1
    got = getattr(tconv, f"{pool}_pool1d")(torch.from_numpy(x), 4).numpy()
    want = np.asarray(getattr(jconv, f"{pool}_pool1d")(jnp.asarray(x), 4))
    assert got.shape == want.shape == (3, 9, 5)
    np.testing.assert_array_equal(got, want)


def test_avg_pool_bf16_within_the_bf16_rule(rng):
    x = (rng.normal(size=(2, 64, 6)) * 3).astype(np.float32)
    got = tconv.avg_pool1d(torch.from_numpy(x).bfloat16(), 4).float().numpy()
    want = np.asarray(jconv.avg_pool1d(jnp.asarray(x, jnp.bfloat16), 4).astype(jnp.float32))
    assert np.all(np.abs(got - want) <= 2e-2 * np.maximum(1.0, np.abs(want)))


# ---------------------------------------------------------------- modules
MODES = {"classifier": {}, "redshift": {"redshift": True},
         "softplus": {"redshift": True, "redshift_softplus": True}, "embedding": {"embedding": True}}


@pytest.mark.parametrize("mode", list(MODES))
def test_spectranet_outputs_match_flax(mode):
    kw = dict(num_classes=9, head_hidden=24, **MODES[mode])
    jm = jsn.SpectraNetModule(channels=CHANNELS, depths=[1, 1], kernel_sizes_per_stage=KERNELS,
                              conv_mode="direct", dtype=jnp.float32, **kw)
    x = _spectra(0)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    port = tsn.SpectraNetModule(CHANNELS, (1, 1), KERNELS, dtype=torch.float32, **kw)
    params, _, state = _carry(shapes, _perturbed_state(port, 3))
    port.load_state_dict(state)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == ((5,) if "redshift" in kw else (5, 24 if mode == "embedding" else 9))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_spectranet_embedding_is_the_classifier_hidden():
    """The embedding mode returns the classifier's pre-dropout hidden bit
    for bit, and its state_dict is the classifier's without the head."""
    clf = tsn.SpectraNetModule(CHANNELS, (1, 1), KERNELS, head_hidden=24)
    emb = tsn.SpectraNetModule(CHANNELS, (1, 1), KERNELS, head_hidden=24, embedding=True)
    state = _perturbed_state(clf, 4)
    assert set(state) - set(emb.state_dict()) == {"head_fc2.weight", "head_fc2.bias"}
    emb.load_state_dict({k: v for k, v in state.items() if not k.startswith("head_fc2")})
    seen = {}
    clf.head_drop.register_forward_hook(lambda m, i, o: seen.setdefault("h", i[0]))
    x = torch.from_numpy(_spectra(1))
    with torch.no_grad():
        clf.eval()(x)
        torch.testing.assert_close(emb.eval()(x), seen["h"], rtol=0, atol=0)


def _tripool_pair(norms: str, classification: bool = True, seed: int = 5):
    jm = jsn.SpectraNetTriPoolModule(
        channels=TRI_CHANNELS, depths=(1, 1, 1), kernel_sizes_per_stage=TRI_KERNELS,
        use_ln_stages=USE_LN[norms], num_classes=9, classification=classification,
        conv_mode="direct", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(_spectra(0))), jax.random.PRNGKey(0))
    port = tsn.SpectraNetTriPoolModule(TRI_CHANNELS, (1, 1, 1), TRI_KERNELS, USE_LN[norms],
                                       num_classes=9, classification=classification, length=L,
                                       dtype=torch.float32)
    params, stats, state = _carry(shapes, _perturbed_state(port, seed))
    port.load_state_dict(state)
    return jm, params, stats, port


@pytest.mark.parametrize("classification", [True, False], ids=["classifier", "embedding"])
@pytest.mark.parametrize("norms", list(USE_LN))
def test_tripool_outputs_match_flax(norms, classification):
    jm, params, stats, port = _tripool_pair(norms, classification)
    assert (stats is not None) == (norms == "bn")
    x = _spectra(2)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 9 if classification else 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_frozen_batchnorm_ignores_train_mode():
    bn = tsn.FrozenBatchNorm(6)
    _perturbed_state(bn, 6)
    x = torch.randn(3, 10, 6, generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    torch.testing.assert_close(bn.train()(x), bn.eval()(x), rtol=0, atol=0)
    assert all(torch.equal(before[k], v) for k, v in bn.state_dict().items())
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias"]


def _fusion_tripool_cfgs(norms: str):
    tri = {"channels": [2, 2, 2], "depths": [1, 1, 1], "kernel_sizes_per_stage": [[3], [3], [3]],
           "use_ln_stages": list(USE_LN[norms])}
    jcfg = jax_load_defaults()
    cfg = load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32"),
                        ("model.AppleCider.spectra_encoder", "tripool"),
                        ("model.SpectraNetTriPool", tri)]:
        jcfg.set(k, v)
        cfg.set(k, v)
    jcfg.set("model.BaselineCLS.dropout", 0.0)
    jcfg.set("model.SpectraNetTriPool.conv_mode", "direct")
    return jcfg, cfg


@pytest.mark.parametrize("norms", list(USE_LN))
def test_fusion_with_tripool_matches_flax(rng, norms):
    jcfg, cfg = _fusion_tripool_cfgs(norms)
    jtask = JaxAppleCiderTask(jcfg)
    B, P = 3, 20
    x = rng.normal(size=(B, P, 7)).astype(np.float32)
    pad = np.arange(P)[None, :] >= rng.integers(8, P + 1, size=B)[:, None]
    meta = rng.normal(size=(B, 24)).astype(np.float32)
    img = rng.normal(size=(B, 63, 63, 3)).astype(np.float32)
    spec = rng.normal(size=(B, tsn.SPECTRUM_BINS)).astype(np.float32)
    batch = (x, pad, meta, img, spec)
    shapes = jax.eval_shape(lambda k: jtask.module.init(k, *map(jnp.asarray, batch)),
                            jax.random.PRNGKey(0))
    port = build_fusion_model(cfg, device="cpu")
    assert isinstance(port.spectra_encoder, tsn.SpectraNetTriPoolModule)
    assert port.spectra_proj.weight.shape == (5, 256)
    params, stats, state = _carry(shapes, _perturbed_state(port, 7))
    port.load_state_dict(state)
    variables = {"params": params, **({"batch_stats": stats} if stats else {})}
    want = np.asarray(jax.jit(lambda v, *b: jtask.module.apply(v, *b, deterministic=True))(
        variables, *map(jnp.asarray, batch)))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_fused_stream_with_tripool_equals_the_monolithic_pipeline():
    """Every TriPool op is per sample, so the compact (S + 1) spectra block
    of ``FusedSpectraStream`` gives what a spectrum a row gives."""
    _, cfg = _fusion_tripool_cfgs("bn")
    model = build_fusion_model(cfg, device="cpu")
    _perturbed_state(model, 8)
    samples = make_alert_samples(7, seed=3, spectrum_frac=0.5, length_range=(3, 30),
                                 spectrum_points=(40, 300))
    fused = ts.FusedSpectraStream(model, spec_buckets=(0, 4, 8), device="cpu")(
        samples, length_buckets=(32,))
    raw = {k: torch.from_numpy(v) for k, v in
           ts.pack_alert_batch(samples, max_photo=32, max_spec=300).items()}
    with torch.no_grad():
        mono = ts.AlertStreamPipeline(model, device="cpu")(raw).numpy()
    np.testing.assert_allclose(fused, mono, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ tasks
def _task_cfgs(name: str, **settings):
    jcfg, cfg = jax_load_defaults(), load_defaults()
    common = [("train.compute_dtype", "float32"), (f'data_set."{SPECTRA_SECTION}".n_bins', L)]
    if name == "SpectraNet":
        common += [("model.SpectraNet.channels", CHANNELS), ("model.SpectraNet.depths", [1, 1]),
                   ("model.SpectraNet.kernel_sizes_per_stage", KERNELS)]
    else:
        common += [("model.SpectraNetTriPool", {
            "channels": TRI_CHANNELS, "depths": [1, 1, 1], "kernel_sizes_per_stage": TRI_KERNELS,
            "use_ln_stages": [False, True, True]})]
    for c in (jcfg, cfg):
        for k, v in common + list(settings.items()):
            c.set(k, v)
    jcfg.set(f"model.{name}.conv_mode", "direct")
    return jcfg, cfg


def _task_pair(name: str, **settings):
    """(JAX task, flax params, port task) with the same weights; the JAX
    TriPool task holds the BatchNorm statistics as its ``batch_stats``."""
    jcfg, cfg = _task_cfgs(name, **settings)
    jtask = (jsn.SpectraNetTask if name == "SpectraNet" else jsn.SpectraNetTriPoolTask)(jcfg)
    task = (tsn.SpectraNetTask if name == "SpectraNet" else tsn.SpectraNetTriPoolTask)(
        cfg, device="cpu")
    shapes = jax.eval_shape(lambda k: jtask.module.init(k, jnp.asarray(_spectra(0))),
                            jax.random.PRNGKey(0))
    params, stats, state = _carry(shapes, _perturbed_state(task.module, 9))
    task.module.load_state_dict(state)
    if stats is not None:
        jtask.batch_stats = stats
    return jtask, params, task


def _spectra_batch(seed: int, B: int = 8):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, L)).astype(np.float32), rng.integers(0, 9, size=B).astype(np.int64),
            rng.uniform(0.0, 0.1, size=B).astype(np.float32))


@pytest.mark.parametrize("name,settings", [
    ("SpectraNet", {}), ("SpectraNet", {"model.SpectraNet.redshift": True}),
    ("SpectraNetTriPool", {})], ids=["classifier", "redshift", "tripool"])
def test_task_loss_and_gradients_match_jax(name, settings):
    jtask, params, task = _task_pair(name, **settings)
    batch = _spectra_batch(1)
    jbatch = (batch[0], batch[1].astype(np.int32), batch[2])
    want, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtask.loss_fn(p, jbatch, jax.random.PRNGKey(0), False)[0]))(params)
    want_g = from_jax_params(jax.tree.map(np.asarray, jgrads))
    task.module.requires_grad_(True)
    loss, aux = task.loss(tuple(map(torch.from_numpy, batch)), train=False)
    loss.backward()
    assert ("logits" in aux) != bool(settings)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5, atol=1e-6)
    for n, p in task.module.named_parameters():
        g, w = p.grad, want_g[n]
        if n.startswith("stage"):  # behind a max or min pool
            assert float((g - w).norm()) <= 1e-3 * max(float(w.norm()), 1e-12), n
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-5 * max(1.0, float(w.abs().max())),
                                       msg=n)


def test_tripool_training_step_keeps_the_batchnorm_statistics(tmp_path):
    _, cfg = _task_cfgs("SpectraNetTriPool")
    task = tsn.SpectraNetTriPoolTask(cfg, device="cpu")
    _perturbed_state(task.module, 10)
    stats = {n: b.clone() for n, b in task.module.named_buffers()}
    params = {n: p.detach().clone() for n, p in task.module.named_parameters()}
    assert len(stats) == 2  # stage 0's BatchNorm: its mean and var
    trainer = Trainer(task, cfg, tmp_path, device="cpu")
    assert task.module.training
    m = trainer.train_step(trainer.to_device(_spectra_batch(2)))
    assert np.isfinite(float(m["loss"]))
    assert all(torch.equal(stats[n], b) for n, b in task.module.named_buffers())
    assert any(not torch.equal(params[n], p) for n, p in task.module.named_parameters())
    assert set(stats) <= set(task.module.state_dict())  # they travel in the checkpoint


def test_tasks_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, cls in (("SpectraNet", tsn.SpectraNetTask),
                      ("SpectraNetTriPool", tsn.SpectraNetTriPoolTask)):
        _, cfg = _task_cfgs(name)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg)


def test_evaluate_scores_against_the_redshifts_as_jax_does(tmp_path):
    """The JAX ``Trainer.evaluate`` takes the batch's last tensor as the
    labels, and ``SpectraNetTask.to_tensor`` puts the redshifts last; the
    port reproduces the report (accuracy 0: no redshift is a class index)."""
    jtask, params, task = _task_pair("SpectraNet")
    jcfg, cfg = _task_cfgs("SpectraNet")
    flux, labels, z = _spectra_batch(3, B=16)
    batches = [{"data": {"flux": flux[i:i + 8], "label": labels[i:i + 8],
                         "redshift": z[i:i + 8]}} for i in (0, 8)]
    want = JaxTrainer(jtask, jcfg, tmp_path / "jax").evaluate(params, batches)
    got = Trainer(task, cfg, tmp_path / "port", device="cpu").evaluate(batches)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["accuracy"] == 0.0


# ---------------------------------------------------------------- runtime
def _spectra_table(path: Path, n: int = 48, seed: int = 0) -> Path:
    """A learnable table: each class's spectra carry a line at its own bin."""
    rng = np.random.default_rng(seed)
    names = list(LABEL_STRINGS)
    idx = rng.integers(0, len(names), size=n)
    flux = rng.normal(0.0, 0.3, size=(n, 1, L)).astype(np.float32)
    flux[np.arange(n), 0, 4 + 6 * idx] += 3.0
    np.savez(path, flux=flux, labels=np.asarray([names[i] for i in idx], dtype=object),
             redshifts=rng.uniform(0.0, 0.1, size=n).astype(np.float32),
             file_paths=np.asarray([f"s{i}.fits" for i in range(n)], dtype=object))
    return path


@pytest.mark.parametrize("settings", [{}, {"model/SpectraNet/redshift": True},
                                      {"model/name": "SpectraNetTriPool"}],
                         ids=["classifier", "redshift", "tripool"])
def test_runtime_trains_and_infers_spectra_toml(tmp_path, settings):
    table = _spectra_table(tmp_path / "spectra.npz")
    overrides = {
        "model": {"SpectraNet": {"channels": CHANNELS, "depths": [1, 1],
                                 "kernel_sizes_per_stage": KERNELS},
                  "SpectraNetTriPool": {"channels": TRI_CHANNELS, "depths": [1, 1, 1],
                                        "kernel_sizes_per_stage": TRI_KERNELS}},
        "train": {"compute_dtype": "float32", "epochs": 2},
        "data_loader": {"batch_size": 8},
        "data_set": {SPECTRA_SECTION: {"n_bins": L}},
        "model_inputs": {"train": {"data": {"data_location": str(table)}},
                         "infer": {"data": {"data_location": str(table)}}},
    }
    for path, value in settings.items():
        node = overrides
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    rt = AppleCiderRuntime(REPO / "configs" / "spectra.toml", overrides, workdir=tmp_path / "r",
                           device="cpu")
    rt.prepare()
    assert isinstance(rt.datasets["train"], SpectraDataset)
    res = rt.train()
    history = res["history"]
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in history)
    assert (res["run_dir"] / "checkpoints" / "last.pt").exists()
    preds = rt.infer()
    redshift = bool(settings.get("model/SpectraNet/redshift"))
    assert preds.shape == ((48,) if redshift else (48, 9))
    assert np.isfinite(preds).all()
