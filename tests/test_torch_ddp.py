"""Data-parallel training and serving on two gloo ranks on the CPU
(``parallel/``), each rank a spawned process (``tests/torch_ddp_worker.py``),
against one process without a group, and BaselineCLS also against the JAX
``Trainer`` on a (2, 1) mesh of conftest's virtual devices.

Two ranks see the rows of one global batch, split, so every quantity of a
step is the global batch's up to the order of f32 sums: losses and
validation metrics within JAX's own multichip tolerance (rtol 2e-4, atol
1e-5), predictions within 1e-5, the last step's gradients and the
parameters within 1e-5 * max(1, |p|). A gradient that is zero but for
rounding (the attention's key bias; a convolution's bias before a
train-mode BatchNorm, which removes it) Adam turns into steps of up to
about lr in a direction each run's rounding picks: those elements, found
by a gradient below 1e-6 of the run's largest, are held within 3 * lr a
step. MPT's masked mean and the zoo's train-mode BatchNorm reduce
their sums over the ranks; the MPT mask is injected as a function of the
rows, since each rank draws its own. Dropout on, the ranks draw different
bits, K4 seeds and MPT masks.
"""

import math

import jax
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.datasets.loader import DataLoader as JaxDataLoader
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu.train.trainer import Trainer as JaxTrainer
from applecider_tpu_torch.ops.dropout import DropoutRNG
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.torch_ddp_worker import ArrayDataset, run_here, spawn

RTOL, ATOL = 2e-4, 1e-5  # JAX's multichip tolerance (tests/test_multichip.py)
LR = 3e-3
WIDTHS = {"d_model": 16, "n_heads": 2, "n_layers": 1, "dropout": 0.0, "lr": LR,
          "pretrain_lr": LR}
BASE = {"train": {"compute_dtype": "float32", "seed": 0, "early_stop_patience": 100},
        "checkpoint": {"resume": False}}
BATCH, EPOCHS = 8, 2  # global batch


def _photometry(rng, n, L=20):
    x = rng.normal(size=(n, L, 7)).astype(np.float32)
    x[..., 4:] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, L))]
    pad = np.arange(L)[None, :] >= rng.integers(6, L + 1, size=n)[:, None]
    return {"photometry": x, "pad_mask": pad, "label": rng.integers(0, 5, n)}


EXTRA = {"mean": np.zeros(4, np.float32), "std": np.ones(4, np.float32)}


def _close(got, want, name: str) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(np.abs(want).max())),
                               err_msg=name)


def _assert_states_close(got: dict, one: dict, steps: int) -> None:
    assert got["state"].keys() == one["state"].keys() and got["grads"].keys() == one["grads"].keys()
    largest = max(float(np.abs(g).max()) for g in one["grads"].values())
    for name, w in one["state"].items():
        g, w = np.array(got["state"][name], np.float64), np.array(w, np.float64)
        if name in one["grads"]:
            _close(got["grads"][name], one["grads"][name], f"grad of {name}")
            noise = np.abs(one["grads"][name]) <= 1e-6 * largest
            assert np.abs(g - w)[noise].max(initial=0.0) <= 3 * LR * steps, name
            g[noise] = w[noise] = 0.0
        _close(g, w, name)


def _assert_same_run(ranks: list, one: dict, steps: int) -> None:
    for r in ranks:
        for h, h1 in zip(r["history"], one["history"], strict=True):
            for k in ("train_loss", "last_grad_norm", "val_loss", "val_accuracy"):
                if k in h1:
                    np.testing.assert_allclose(h[k], h1[k], rtol=RTOL, atol=ATOL, err_msg=k)
        _assert_states_close(r, one, steps)
    # rank 0 wrote the files: one record an epoch, the two checkpoints
    assert ranks[0]["files"] == one["files"]
    assert all(f in one["files"] for f in ("run/metrics.jsonl", "run/checkpoints/last.pt"))


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The data, the JAX init (both packages' start) and the JAX Trainer's
    run on a (2, 1) mesh with global batches of 8."""
    rng = np.random.default_rng(3)
    train, val = _photometry(rng, 32), _photometry(rng, 16)
    over = {**BASE, "model": {"name": "BaselineCLS", "BaselineCLS": WIDTHS}}
    jcfg = jax_load_defaults().merged_with({**over, "parallel": {"mesh_shape": [2, 1]}})
    jtask = JaxBaselineCLSTask(jcfg)
    batch0 = jtask.to_tensor(ArrayDataset(train, EXTRA).collate(
        [ArrayDataset(train).sample(i) for i in range(BATCH)]))
    params = jax.tree.map(np.asarray, jtask.init(jax.random.PRNGKey(0), batch0)["params"])
    with pytest.warns(UserWarning, match="uses 2 of 8"):
        jtrainer = JaxTrainer(jtask, jcfg, tmp_path_factory.mktemp("jax"))
    jres = jtrainer.fit(JaxDataLoader(ArrayDataset(train, EXTRA), batch_size=BATCH, shuffle=False),
                        JaxDataLoader(ArrayDataset(val, EXTRA), batch_size=BATCH, shuffle=False),
                        epochs=EPOCHS, init_params=params)
    args = {"overrides": over, "train": train, "val": val, "extra": EXTRA, "batch": BATCH,
            "epochs": EPOCHS, "predict_batch": 3,
            "init": {k: v for k, v in from_jax_params(params).items()}}
    one = run_here("fit", args, tmp_path_factory.mktemp("one"))
    return args, jres, one


@pytest.mark.parametrize("mesh_shape", [[2, 1], [1, 2]])
def test_baseline_cls_fit_matches_one_process_and_jax(baseline, tmp_path, mesh_shape):
    """(2, 1): each rank half of every batch; (1, 2): two replicas of the
    whole batch (the model axis)."""
    args, jres, one = baseline
    args = {**args, "overrides": {**args["overrides"], "parallel": {"mesh_shape": mesh_shape}}}
    ranks = spawn("fit", args, tmp_path)
    assert [r["mesh"] for r in ranks] == [dict(zip(("data", "model"), mesh_shape))] * 2
    _assert_same_run(ranks, one, steps=EPOCHS * 4)
    jax_losses = [h["train_loss"] for h in jres["history"]]
    for r in ranks:
        np.testing.assert_allclose([h["train_loss"] for h in r["history"]], jax_losses,
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose([h["val_loss"] for h in r["history"]],
                                   [h["val_loss"] for h in jres["history"]], rtol=RTOL, atol=ATOL)
        # rows in dataset order, the 4 that batch 3 leaves to no shard included
        np.testing.assert_allclose(r["predict"], one["predict"], rtol=0, atol=1e-5)
    assert one["predict"].shape == (16, 5)


def test_mpt_masked_mean_over_ranks_equals_one_process(tmp_path):
    rng = np.random.default_rng(4)
    args = {"overrides": {**BASE, "model": {"name": "MPT", "BaselineCLS": WIDTHS}},
            "train": _photometry(rng, 16), "extra": EXTRA, "batch": BATCH, "epochs": EPOCHS,
            "row_mask": True}
    one = run_here("fit", args, tmp_path / "one")
    ranks = spawn("fit", args, tmp_path / "two")
    _assert_same_run(ranks, one, steps=EPOCHS * 2)


def test_zoo_train_mode_batchnorm_over_ranks_equals_one_process(tmp_path):
    rng = np.random.default_rng(5)
    spec = {"arch": "tiny", "s_dim": 8, "head_features": 16, "dropout": 0.0, "lr": LR}
    args = {"overrides": {**BASE, "model": {"name": "SpectraEfficientNetV2",
                                            "SpectraEfficientNetV2": spec}},
            "train": {"image": rng.normal(size=(12, 32, 32, 3)).astype(np.float32),
                      "label": rng.integers(0, 5, 12)},
            "batch": 6, "epochs": 1}
    one = run_here("fit", args, tmp_path / "one")
    ranks = spawn("fit", args, tmp_path / "two")
    _assert_same_run(ranks, one, steps=2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from applecider_tpu_torch.datasets.photo_dataset import compute_photo_feature_stats
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus

    root = tmp_path_factory.mktemp("ddp_corpus")
    data_dir, labels_csv = make_corpus(root, n_objects=12, seed=21, n_photometry=18, n_alerts=4)
    out = root / "out"
    preprocess_data(str(data_dir), str(labels_csv), str(out), min_per_class=1, seed=42)
    compute_photo_feature_stats(out / "manifest_train.csv", 100.0, out / "photo_stats.npz")
    return out


def test_runtime_verbs_on_two_ranks(corpus, tmp_path):
    """``train`` and ``infer`` through ``AppleCiderRuntime`` with
    ``[parallel.multihost]``: one run directory, one writer, the losses,
    validation metrics and predictions of one process (global batch 8)."""
    from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset

    def overrides(batch):
        return {**BASE, "model": {"name": "BaselineCLS", "BaselineCLS": WIDTHS},
                "train": {**BASE["train"], "epochs": 2},
                "data_loader": {"batch_size": batch, "seed": 11, "drop_last": False},
                "data_set": {PhotoEventsDataset.SECTION: {
                    "manifest_path": str(corpus / "manifest_train.csv"),
                    "stats_path": str(corpus / "photo_stats.npz"), "use_oversampling": False}},
                "model_inputs": {p: {"data": {"dataset_class": "PhotoEventsDataset"}}
                                 for p in ("train", "validate", "infer")}}

    one = run_here("runtime", {"overrides": overrides(8), "workdir": tmp_path / "one"}, tmp_path)
    ranks = spawn("runtime", {"overrides": overrides(4), "workdir": tmp_path / "two"}, tmp_path)
    r0, r1 = ranks
    assert r0["run_dir"] == r1["run_dir"]
    assert [d.split("-", 3)[-1] for d in r0["dirs"]] == ["train-BaselineCLS", "infer-BaselineCLS"]
    assert r0["metrics_lines"] == 2  # one record an epoch: one writer
    assert r0["odd_leftover"]  # batch 3 leaves rows to no shard
    for r in ranks:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=RTOL, atol=ATOL)
        for v, v1 in zip(r["val"], one["val"], strict=True):
            assert v.keys() == v1.keys()
            np.testing.assert_allclose([v[k] for k in v1], list(v1.values()), rtol=RTOL,
                                       atol=ATOL)
        for key in ("preds", "preds_odd"):
            np.testing.assert_allclose(r[key], one[key], rtol=0, atol=1e-5, err_msg=key)


def test_streams_with_mesh_equal_the_unsharded_streams(tmp_path):
    from tests.test_torch_pipeline import GRID, TINY

    over = {"train": {"compute_dtype": "float32"}}
    for key, value in TINY:
        section, model, field = key.split(".")
        over.setdefault(section, {}).setdefault(model, {})[field] = value
    ranks = spawn("streams", {"overrides": over, "grid": GRID}, tmp_path)
    for r in ranks:
        for key, value in r.items():
            if key.endswith("_local_rows"):
                continue
            got, want = value
            assert got.shape == want.shape and np.isfinite(got).all(), key
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=key)
        # the compact block's batch: half the rows a rank, or every row if ragged
        assert (r["fused_8_local_rows"], r["fused_7_local_rows"]) == (4, 7)
    np.testing.assert_array_equal(ranks[0]["fused_8"][0], ranks[1]["fused_8"][0])


def test_ranks_draw_their_own_dropout(tmp_path):
    over = {**BASE, "model": {"name": "BaselineCLS", "BaselineCLS": {**WIDTHS, "dropout": 0.5}}}
    r0, r1 = spawn("dropout", {"overrides": over}, tmp_path)
    for key in ("dropout", "k4_seeds", "mpt_mask"):
        assert not np.array_equal(r0[key], r1[key]), key
    assert 0.4 < r0["dropout"].mean() < 0.6 and 0.4 < r1["dropout"].mean() < 0.6
    assert np.isfinite([r0["step_loss"], r1["step_loss"]]).all()
    # rank 0 draws what one process draws: its stream is the seed itself
    ref = DropoutRNG(0, "cpu")
    assert r0["k4_seeds"] == torch.randint(0, 2**31 - 1, (4,), generator=ref.cpu).tolist()


@pytest.mark.parametrize("world, shape", [(2, (1, 2)), (4, (2, 2))])
def test_make_mesh_reuses_its_process_groups(tmp_path, world, shape):
    """A second ``make_mesh`` of the same shape returns the same process
    groups and makes none: on two ranks as (1, 2) (the model axis is the
    whole world), and on four as (2, 2), where each axis has groups of its
    own (two lines an axis, made once)."""
    ranks = spawn("mesh_groups", {"shape": shape}, tmp_path, world=world)
    # each axis neither one rank nor the whole world: prod(shape) / size lines
    lines = sum(math.prod(shape) // s for s in shape if s not in (1, world))
    for r in ranks:
        assert r["same"] and all(r["same"].values()), r
        assert r["made_second"] == 0
        assert r["made_first"] == lines
    if world == 4:  # ranks 0 and 2 share a data line, as do 1 and 3
        assert [r["data_sum"] for r in ranks] == [4.0, 6.0, 4.0, 6.0]


FROZEN_TINY = {"model": {"BaselineCLS": {"d_model": 16, "n_heads": 2, "n_layers": 1,
                                         "dropout": 0.0},
                         "SpectraNet": {"channels": [4, 8, 8], "depths": [1, 1, 1],
                                        "kernel_sizes_per_stage": [[3, 61], [3, 31], [3, 15]],
                                        "conv_mode": "direct"},
                         "AstroMiNN": {"backbone_depths": [1, 1], "backbone_dims": [8, 16]},
                         "AppleCider": {"lr": 3e-3}},
               "train": {"compute_dtype": "float32", "seed": 0},
               "checkpoint": {"resume": False}}


def test_two_ranks_meet_one_process_after_training_with_spectranet_frozen(tmp_path):
    """After three f32 steps, two ranks' predictions meet one process's
    within 1e-5 when SpectraNet is frozen: the trained-weights gap of
    ``chip_smoke.py`` phase 13b comes from SpectraNet's parameters, whose
    gradients pass through max pools that route a few of them to another
    argmax when a sum's order changes (the two runs' other parameters agree
    to rounding). The unfrozen gap is reported beside it."""
    args = {"overrides": FROZEN_TINY, "batch": 16, "steps": 3, "n_predict": 19,
            "max_len": 24, "spec_bins": 512}
    gaps = {}
    for tag, freeze in (("frozen", ["spectra_encoder"]), ("trained", [])):
        one = run_here("frozen_fusion", {**args, "freeze": freeze}, tmp_path / f"one-{tag}")
        ranks = spawn("frozen_fusion", {**args, "freeze": freeze}, tmp_path / f"two-{tag}")
        gaps[tag] = max(float(np.abs(r["preds"] - one["preds"]).max()) for r in ranks)
        if freeze:  # SpectraNet's weights are the same seed-0 draw in every run
            for r in ranks:
                for k, v in r["state"].items():
                    if k.startswith("spectra_encoder."):
                        np.testing.assert_array_equal(v, one["state"][k], err_msg=k)
    print(f"trained predictions, two ranks vs one process: SpectraNet frozen {gaps['frozen']:.3g}, "
          f"trained {gaps['trained']:.3g}")
    assert gaps["frozen"] <= 1e-5, gaps
