"""The port's ``AppleCiderRuntime`` on the CPU through the user's workflow:
``prepare``, ``train`` (checkpoints, metrics, resume), ``infer``, ``serve``,
``warmup`` and the two CLIs, at small widths in f32, on a corpus that the
port's ``preprocess_data`` built.

With the same weights in both packages (drawn by the port, laid out as flax
params, carried back by ``from_jax_params``; direct convs on the JAX side),
``Trainer.predict`` agrees with the JAX ``Trainer.predict`` and
``rt.serve(params=...)`` with the JAX ``rt.serve(params=...)``, alert by
alert, within 1e-4 (atol; logits and probabilities). Each option the port
has not ported raises and names itself; each zoo model trains and infers.
The fusion model with the TriPool spectra encoder trains, infers and
serves, the serving run equal to ``serve_alert_stream`` on the weights of
``best.pt``.
"""

import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _fusion_batch
from chip_smoke import _toml
from applecider_tpu.config import load_config as jax_load_config
from applecider_tpu.datasets.fusion_dataset import FusionDataset as JaxFusionDataset
from applecider_tpu.datasets.loader import DataLoader as JaxDataLoader
from applecider_tpu.models.fusion import AppleCiderTask
from applecider_tpu.train.runtime import AppleCiderRuntime as JaxRuntime
from applecider_tpu.train.trainer import Trainer as JaxTrainer
from applecider_tpu_torch import registry
from applecider_tpu_torch.datasets.fusion_dataset import FusionDataset
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset, load_photo_stats
from applecider_tpu_torch.infer import serve as serve_mod
from applecider_tpu_torch.infer.cli import main as serve_main
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.preprocessing.cli import preprocess_data
from applecider_tpu_torch.testing import make_corpus
from applecider_tpu_torch.train.runtime import AppleCiderRuntime
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_pipeline import _flax_params

REPO = Path(__file__).resolve().parents[1]
SEC = JaxFusionDataset.SECTION
BATCH = 4


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """A raw corpus of 12 objects and the port's preprocessing of it."""
    root = tmp_path_factory.mktemp("runtime")
    data_dir, labels = make_corpus(root, n_objects=12, seed=21, n_photometry=18, n_alerts=4,
                                   spectrum_frac=0.5)
    preprocess_data(str(data_dir), str(labels), str(root / "out"), min_per_class=1, seed=42)
    return root


def _overrides(prepared, **extra) -> dict:
    out = prepared / "out"
    tiny = {
        "model": {"name": "AppleCider",
                  "BaselineCLS": {"d_model": 16, "n_heads": 2, "n_layers": 1},
                  "SpectraNet": {"channels": [4, 8], "depths": [1, 1],
                                 "kernel_sizes_per_stage": [[3, 7], [3, 5]],
                                 "conv_mode": "direct"},  # JAX only: no FFT convs
                  "AstroMiNN": {"backbone_depths": [1, 1], "backbone_dims": [8, 16]}},
        "train": {"compute_dtype": "float32", "epochs": 2},
        "data_loader": {"batch_size": BATCH, "drop_last": False},
        "data_set": {SEC: {"manifest_path": str(out / "manifest_train.csv"),
                           "stats_event_path": str(out / "photo_stats.npz")}},
        "serve": {"batch_size": 4, "length_buckets": [64]},
    }
    for path, value in extra.items():
        node = tiny
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tiny


def _runtime(prepared, workdir, **extra) -> AppleCiderRuntime:
    return AppleCiderRuntime(REPO / "configs" / "fusion.toml", _overrides(prepared, **extra),
                             workdir=workdir, device="cpu")


@pytest.fixture(scope="module")
def trained(prepared, tmp_path_factory):
    rt = _runtime(prepared, tmp_path_factory.mktemp("results"))
    rt.prepare()
    return rt, rt.train()


@pytest.fixture(scope="module")
def carried(prepared):
    """(JAX task, flax params, the port's state_dict): the same weights."""
    jcfg = jax_load_config(REPO / "configs" / "fusion.toml", _overrides(prepared))
    task = AppleCiderTask(jcfg)
    shapes = jax.eval_shape(lambda k: task.init(k, _fusion_batch(2, tiny=True)),
                            jax.random.PRNGKey(0))["params"]
    rt = _runtime(prepared, prepared / "unused")
    params = _flax_params(shapes, rt._task().module.state_dict())
    return task, params, from_jax_params(params)


def test_prepare_train_checkpoints_and_resume(trained, prepared):
    rt, result = trained
    assert set(rt.datasets) == {"train", "validate", "infer"}
    assert all(isinstance(d, FusionDataset) for d in rt.datasets.values())
    run_dir = result["run_dir"]
    assert [r["epoch"] for r in result["history"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in result["history"])
    assert (run_dir / "checkpoints" / "best.pt").exists()
    assert (run_dir / "checkpoints" / "last.pt").exists()
    assert json.loads((run_dir / "run.json").read_text())["verb"] == "train"
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0, 1]
    steps = records[-1]["steps"]
    # resume: a Trainer on the same run continues at the next epoch
    resumed = Trainer(rt._task(), rt.config, run_dir, device="cpu").fit(
        rt._loader(rt.datasets["train"], shuffle=True), epochs=3)
    assert [r["epoch"] for r in resumed["history"]] == [2]
    assert resumed["history"][0]["steps"] == steps + steps // 2


def test_infer_reads_the_trained_weights(trained):
    rt, result = trained
    preds = rt.infer()
    assert preds.shape == (len(rt.datasets["infer"]), 5) and np.isfinite(preds).all()
    saved = sorted(rt.workdir.glob("*-infer-AppleCider/predictions.npy"))
    np.testing.assert_array_equal(np.load(saved[-1]), preds)
    # the weights are best.pt's: the same predictions from a model holding them
    trainer = Trainer(rt._task(), rt.config, result["run_dir"], device="cpu")
    assert trainer.restore_weights() == "best"
    loader = rt._loader(rt.datasets["infer"], shuffle=False)
    np.testing.assert_array_equal(trainer.predict(loader), preds)
    assert not np.array_equal(Trainer(rt._task(), rt.config, result["run_dir"] / "x",
                                      device="cpu").predict(loader), preds)


@pytest.mark.parametrize("probabilities", [False, True])
def test_predict_matches_jax(prepared, carried, tmp_path, probabilities):
    task, params, state = carried
    extra = {"model/AppleCider/use_probabilities": probabilities}
    jcfg = jax_load_config(REPO / "configs" / "fusion.toml", _overrides(prepared, **extra))
    jtask = AppleCiderTask(jcfg)
    # batches of 8 there and of 3 here: rows come back in dataset order either way
    want = JaxTrainer(jtask, jcfg, tmp_path / "jax").predict(
        params, JaxDataLoader(JaxFusionDataset(jcfg), batch_size=8, shuffle=False))
    rt = _runtime(prepared, tmp_path, **extra)
    task = rt._task()
    task.module.load_state_dict(state)
    got = Trainer(task, rt.config, tmp_path / "port", device="cpu").predict(
        DataLoader(FusionDataset(rt.config), batch_size=3, shuffle=False))
    assert got.shape == np.asarray(want).shape == (len(FusionDataset(rt.config)), 5)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)
    if probabilities:
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_serve_matches_jax(prepared, carried, tmp_path):
    """Every alert of the raw corpus, in order, with the training stats
    (the fusion dataset's, through the fallback) and its horizon."""
    _, params, state = carried
    want = JaxRuntime(REPO / "configs" / "fusion.toml", _overrides(prepared),
                      workdir=tmp_path / "jax").serve(raw_path=prepared / "raw", params=params)
    got = _runtime(prepared, tmp_path / "port").serve(raw_path=prepared / "raw", params=state)
    assert got["n_alerts"] == want["n_alerts"] == len(got["results"]) > 20
    for g, w in zip(got["results"], want["results"]):
        assert {k: v for k, v in g.items() if k != "probs"} == \
            {k: v for k, v in w.items() if k != "probs"}
        np.testing.assert_allclose(g["probs"], w["probs"], rtol=0, atol=1e-4)
    rows = (got["run_dir"] / "alerts.jsonl").read_text().splitlines()
    assert len(rows) == got["n_alerts"]
    assert json.loads((got["run_dir"] / "serve.json").read_text())["n_alerts"] == got["n_alerts"]


def test_tripool_fusion_trains_infers_and_serves(prepared, tmp_path):
    tri = {"channels": [2, 2, 2], "depths": [1, 1, 1], "kernel_sizes_per_stage": [[3], [3], [3]],
           "use_ln_stages": [False, True, True]}
    rt = _runtime(prepared, tmp_path, **{"model/AppleCider/spectra_encoder": "tripool",
                                         "model/SpectraNetTriPool": tri})
    rt.prepare()
    res = rt.train()
    assert all(np.isfinite(r["train_loss"]) for r in res["history"])
    assert any(k.endswith("running_var") for k in rt._task().module.state_dict())
    preds = rt.infer()
    assert preds.shape == (len(rt.datasets["infer"]), 5) and np.isfinite(preds).all()
    served = rt.serve(raw_path=prepared / "raw")
    model = build_fusion_model(rt.config, device="cpu")
    model.load_state_dict(torch.load(res["run_dir"] / "checkpoints" / "best.pt",
                                     weights_only=True)["params"])
    sec = rt.config.section("serve")
    mean, std = load_photo_stats(prepared / "out" / "photo_stats.npz")
    direct = serve_mod.serve_alert_stream(
        model, serve_mod.iter_alert_samples(prepared / "raw"), batch_size=sec["batch_size"],
        length_buckets=tuple(sec["length_buckets"]), stats_mean=mean, stats_std=std,
        horizon_days=100.0, device="cpu")
    assert served["n_alerts"] == direct["n_alerts"] > 20
    np.testing.assert_allclose([r["probs"] for r in served["results"]],
                               [r["probs"] for r in direct["results"]], rtol=0, atol=1e-6)


def test_serve_falls_back_to_dataset_stats(prepared, tmp_path, monkeypatch):
    """[serve] without stats_event_path normalises with the fusion
    dataset's training stats; [serve].horizon_days overrides the dataset's
    horizon ("none": off)."""
    stats = tmp_path / "stats.npz"
    np.savez(stats, mean=np.arange(4, dtype=np.float32), std=np.full(4, 2.0, np.float32))
    captured = {}

    def fake_serve(model, samples, **kw):
        captured.update(kw)
        return {"n_alerts": 0, "seconds": 0.0, "alerts_per_sec": 0.0, "results": []}

    monkeypatch.setattr(serve_mod, "serve_alert_stream", fake_serve)
    rt = _runtime(prepared, tmp_path / "results", **{f"data_set/{SEC}/stats_event_path": str(stats),
                                                     f"data_set/{SEC}/horizon": 30.0})
    params = rt._task().module.state_dict()
    rt.serve(raw_path=prepared / "raw", params=params)
    np.testing.assert_array_equal(captured["stats_mean"], np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(captured["stats_std"], np.full(4, 2.0))
    assert captured["horizon_days"] == 30.0
    rt.set_config("serve.horizon_days", "none")
    rt.serve(raw_path=prepared / "raw", params=params)
    assert captured["horizon_days"] is None


def test_serve_cli_uses_the_latest_trained_run(trained, prepared, tmp_path, capsys):
    rt, _ = trained
    config = tmp_path / "run.toml"
    config.write_text(_toml(_overrides(prepared)))
    assert serve_main(["--config", str(config), "--raw_path", str(prepared / "raw"),
                       "--workdir", str(rt.workdir), "--device", "cpu", "--batch_size", "16"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    direct = rt.serve(raw_path=prepared / "raw")
    assert out["n_alerts"] == direct["n_alerts"] > 20
    served = [json.loads(line) for line in
              (Path(out["run_dir"]) / "alerts.jsonl").read_text().splitlines()]
    np.testing.assert_allclose([r["probs"] for r in served],
                               [r["probs"] for r in direct["results"]], rtol=0, atol=1e-6)
    assert serve_main(["--config", str(config), "--workdir", str(rt.workdir), "--device", "cpu",
                       "--batch_size", "4", "--warmup"]) == 0
    warm = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [(p["length_bucket"], p["spectra_bucket"]) for p in warm["programs"]] == [(64, 0), (64, 4)]


def test_warmup_without_a_trained_run_warns(prepared, tmp_path):
    rt = _runtime(prepared, tmp_path / "empty", **{"serve/length_buckets": [16, 32]})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = rt.warmup(batch_size=4)
    assert any("random weights" in str(w.message) and "no trained run" in str(w.message)
               for w in caught)
    assert [(p["length_bucket"], p["spectra_bucket"]) for p in out["programs"]] == \
        [(16, 0), (16, 4), (32, 0), (32, 4)]
    assert out["build_seconds"] == 0.0 and out["total_seconds"] > 0


RAISES = {
    # no rendezvous is configured and no launcher set one: named, before any wait
    "parallel/multihost/enable":
        r"parallel\.multihost\.coordinator_address or MASTER_ADDR and MASTER_PORT",
    # one process, as JAX's make_mesh with one device
    "parallel/mesh_shape": r"mesh shape \(2, 4\) needs 8 devices, have 1",
}


@pytest.mark.parametrize("key,value,verb", [
    ("parallel/multihost/enable", True, "train"),
    ("parallel/mesh_shape", [2, 4], "train"),
])
def test_unported_options_raise(prepared, tmp_path, monkeypatch, key, value, verb):
    """The parallel options are ported; each refuses a setting it cannot
    serve in one process without a launcher."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=RAISES[key]):
        getattr(_runtime(prepared, tmp_path, **{key: value}), verb)()


class ZooBatches:
    """Every zoo input in the layout the zoo's tasks read (images NHWC; the
    fusion data set's cutouts are channel-first), drawn from a seed named
    by ``data_location``: 10 samples of a 32 x 32 x 3 image, a 200-bin
    spectrum, 24 metadata columns, 40 events of 7 features, a label."""

    def __init__(self, config, location: str):
        rng = np.random.default_rng(sum(location.encode()))
        shapes = {"image": (32, 32, 3), "spectrum": (200,), "metadata": (24,),
                  "photometry": (40, 7)}
        self.samples = [{**{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
                         "label": int(rng.integers(0, 5))} for _ in range(10)]

    def __len__(self) -> int:
        return len(self.samples)

    def sample(self, idx: int) -> dict:
        return self.samples[idx]

    def collate(self, samples: list) -> dict:
        return {"data": {k: np.stack([s[k] for s in samples]) for k in samples[0]}}


registry.register_dataset(ZooBatches, name="ZooBatches")

# each zoo model at tiny widths, and its (n, classes) predictions
ZOO_TINY = {
    "BTSModel": ({"conv1_channels": 4, "conv2_channels": 4}, 5),
    "GalSpecNet": ({"conv_channels": [1, 4, 4]}, 9),
    "MetaModel": ({"hidden_dim": 8}, 5),
    "Informer": ({"d_model": 8, "n_heads": 2, "n_layers": 1}, 5),
    "SpectraViT": ({"backbone_dim": 16, "backbone_depth": 1, "s_dim": 8}, 9),
    "SpectraEfficientNetV2": ({"arch": "tiny", "s_dim": 8, "head_features": 16}, 9),
    "SpectraConvNeXt": ({"depths": [1, 1], "dims": [4, 8]}, 9),
}


@pytest.mark.parametrize("name", list(ZOO_TINY))
def test_zoo_models_train_and_infer(prepared, tmp_path, name):
    """Each zoo name (the JAX dotted one for Informer) trains through
    ``AppleCiderRuntime.train`` on a data set whose batch carries every zoo
    input key (image, spectrum, metadata, photometry), sized by its first
    batch: finite losses, both checkpoints; then ``infer`` restores it,
    sized from the infer set, and predicts every row."""
    fields, classes = ZOO_TINY[name]
    model = f"applecider_tpu.models.zoo.{name}Task" if name == "Informer" else name
    rt = _runtime(prepared, tmp_path, **{"model/name": model, f"model/{name}": fields,
                                         "train/epochs": 1}, **{
        f"model_inputs/{phase}/data": {"dataset_class": "ZooBatches", "data_location": phase}
        for phase in ("train", "validate", "infer")})
    result = rt.train()
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in result["history"])
    assert (result["run_dir"] / "checkpoints" / "last.pt").exists()
    assert (result["run_dir"] / "checkpoints" / "best.pt").exists()
    preds = rt.infer()
    assert preds.shape == (len(rt.datasets["infer"]), classes) and np.isfinite(preds).all()


@pytest.mark.parametrize("key,value", [
    ("train/freeze_params", ["photometry_encoder"]),
    ("train/grad_accum_steps", 2),
    ("train/plateau_factor", 0.5),
    ("train/ema_decay", 0.99),
    ("train/remat", True),
    ("model/name", "BaselineCLS"),
])
def test_ported_options_train(prepared, tmp_path, key, value):
    """Each option the port now has trains through the runtime: two epochs,
    finite losses, and its own mark on the run (frozen weights unmoved,
    half the optimizer steps' worth of state, the plateau scale logged, the
    EMA shadow checkpointed, the classifier's report logged)."""
    rt = _runtime(prepared, tmp_path, **{key: value})
    result = rt.train()
    history = result["history"]
    assert [r["epoch"] for r in history] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in history)
    last = torch.load(result["run_dir"] / "checkpoints" / "last.pt", weights_only=True)
    init = rt._task().module.state_dict()
    assert set(last["params"]) == set(init)
    if key == "train/freeze_params":
        frozen = [n for n in init if n.startswith("photometry_encoder.")]
        assert frozen and all(torch.equal(last["params"][n], init[n]) for n in frozen)
        assert any(not torch.equal(last["params"][n], init[n]) for n in init if n not in frozen)
    elif key == "train/grad_accum_steps":
        assert last["grad_accum"]["mini_step"] == last["step"] % 2
        adam_steps = {int(s["step"]) for s in last["opt_state"]["state"].values()}
        assert adam_steps == {last["step"] // 2}
    elif key == "train/plateau_factor":
        assert all(r["lr_scale"] == 1.0 for r in history)
        assert len(last["plateau"]) == 3
    elif key == "train/ema_decay":
        best = torch.load(result["run_dir"] / "checkpoints" / "best.pt", weights_only=True)
        assert set(last["ema"]) == set(init)
        assert not all(torch.equal(last["ema"][n], last["params"][n]) for n in init)
        assert best["params"].keys() == init.keys()
    else:
        assert {"val_accuracy", "val_macro_f1", "val_top3_accuracy"} <= set(history[0])
        assert rt.infer().shape == (len(rt.datasets["infer"]), 5)


@pytest.mark.parametrize("model", ["BaselineCLS", "MPT"])
def test_photometry_config_trains_and_infers(prepared, tmp_path, model):
    """``configs/photometry.toml`` as it is, and with ``model.name = "MPT"``:
    prepare binds PhotoEventsDataset to every phase, train checkpoints,
    infer returns the classifier's (n, 5) logits or MPT's (n, L, 5) heads;
    serve refuses a model other than the fusion model."""
    out = prepared / "out"
    overrides = {
        "model": {"name": model, "BaselineCLS": {"d_model": 16, "n_heads": 2, "n_layers": 1}},
        "train": {"compute_dtype": "float32", "epochs": 2},
        "data_loader": {"batch_size": BATCH, "drop_last": False},
        "data_set": {PhotoEventsDataset.SECTION: {
            "manifest_path": str(out / "manifest_train.csv"),
            "stats_path": str(out / "photo_stats.npz"), "max_len": 32}},
    }
    rt = AppleCiderRuntime(REPO / "configs" / "photometry.toml", overrides, workdir=tmp_path,
                           device="cpu")
    rt.prepare()
    assert all(isinstance(d, PhotoEventsDataset) for d in rt.datasets.values())
    result = rt.train()
    assert [r["epoch"] for r in result["history"]] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in result["history"])
    assert (result["run_dir"] / "checkpoints" / "best.pt").exists()
    assert ("val_accuracy" in result["history"][0]) == (model == "BaselineCLS")
    preds = rt.infer()
    n = len(rt.datasets["infer"])
    assert preds.shape == ((n, 5) if model == "BaselineCLS" else (n, 32, 5))
    assert np.isfinite(preds).all()
    with pytest.raises(ValueError, match="fusion model"):
        rt.serve(raw_path=prepared / "raw")


def test_runtime_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AppleCiderRuntime(REPO / "configs" / "fusion.toml")

