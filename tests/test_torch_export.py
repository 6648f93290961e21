"""The port's deployment artifacts on the CPU: K1, K2 and K3f as custom ops
(``torch.library.opcheck``); ``export_serving``'s programs, which hold the
three ops as graph nodes and equal the port's live pipeline (<= 1e-6) and
the JAX ``AlertStreamPipeline`` (rtol 2e-5, atol 2e-6, the JAX test's own)
at batch 1, 4 and 7; ``engine_serving`` against the live serve, with no
model code, and on a concrete-batch export; ``export``/``engine`` against
``infer``, with a ragged tail, skipping ``export_serving`` directories.

Small widths, the JAX tests' tiny config (``tests/test_serve.py``), with the
JAX weights carried over by ``utils.weights.from_jax_params``. One serving
artifact is exported per module and shared.
"""

import json

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _fusion_batch, _fusion_task
from applecider_tpu.infer import stream as js
from applecider_tpu.models.fusion import AppleCiderTask
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.infer import stream as ts
from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.models.fusion import AppleCiderModule
from applecider_tpu_torch.ops import attention, ln_gelu, merge_scan
from applecider_tpu_torch.testing import make_alert_samples, make_corpus
from applecider_tpu_torch.train.runtime import AppleCiderRuntime
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_pipeline import GRID, TINY, _flax_params, pair  # noqa: F401  (fixture)
from tests.test_torch_runtime import BATCH, _runtime, prepared  # noqa: F401  (fixture)

BUCKET = 32
OPS = {"seg_ids": merge_scan.seg_ids_op, "masked_attention": attention.masked_attention_op,
       "ln_gelu_fwd": ln_gelu.ln_gelu_fwd_op}
SERVING_TINY = {
    "model": {"name": "Fusion",
              "BaselineCLS": {"d_model": 16, "n_heads": 2, "n_layers": 1, "dropout": 0.0},
              "SpectraNet": {"channels": [4, 8], "depths": [1, 1],
                             "kernel_sizes_per_stage": [[3, 7], [3, 5]]},
              "AstroMiNN": {"backbone_depths": [1, 1], "backbone_dims": [8, 16]}},
    "train": {"compute_dtype": "float32"},
    "serve": {"batch_size": 4},
}


def _op_nodes(program) -> dict:
    """How many nodes of the program's graph call each custom op."""
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    return {name: sum(t == f"applecider_torch.{name}.default" for t in targets) for name in OPS}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir, _ = make_corpus(tmp_path_factory.mktemp("export_corpus"), n_objects=5, seed=7,
                              n_photometry=24, n_alerts=5)
    return data_dir


@pytest.fixture(scope="module")
def served(pair, corpus, tmp_path_factory):
    """(runtime, the serving export of ``pair``'s weights at bucket 32,
    the live ``serve_alert_stream`` of the corpus on those weights)."""
    _, _, model = pair
    root = tmp_path_factory.mktemp("export_serving")
    rt = AppleCiderRuntime(overrides=SERVING_TINY, workdir=root / "results", device="cpu")
    out = rt.export_serving(out_path=root / "exp", length_buckets=(BUCKET,),
                            params=model.state_dict(), wave_grid=GRID)
    live = serve_alert_stream(model, iter_alert_samples(corpus), batch_size=4,
                              length_buckets=(BUCKET,), wave_grid=GRID, device="cpu")
    return rt, out, live


@pytest.fixture(scope="module")
def loaded(served):
    """The serving program, loaded from its ``.pt2``."""
    return torch.export.load(served[1] / f"serving_P{BUCKET}.pt2").module()


def _probs(summary) -> np.ndarray:
    return np.stack([r["probs"] for r in summary["results"]])


def _op_args(name):
    g = torch.Generator().manual_seed(0)
    if name == "seg_ids":
        valid = torch.rand(3, 9, generator=g) > 0.2
        t = torch.where(valid, torch.sort(torch.rand(3, 9, generator=g) * 3, dim=1).values,
                        float("inf"))
        return t, torch.randint(0, 3, (3, 9), generator=g, dtype=torch.int32), valid, 0.5
    if name.startswith("masked_attention"):
        q, k, v = (torch.randn(2, 2, 5, 8, generator=g) for _ in range(3))
        mask = torch.zeros(2, 5, dtype=torch.bool)
        mask[0, 3:] = True
        return q, k, v, (None if name.endswith("no_mask") else mask)
    return torch.randn(4, 3, 6, generator=g), torch.rand(6, generator=g), \
        torch.rand(6, generator=g), 1e-5


@pytest.mark.parametrize("name", ["seg_ids", "masked_attention", "masked_attention_no_mask",
                                  "ln_gelu_fwd"])
def test_custom_ops_pass_opcheck(name):
    op = OPS[name.removesuffix("_no_mask")]
    result = torch.library.opcheck(op, _op_args(name))
    assert set(result.values()) == {"SUCCESS"}, result


def test_serving_graph_holds_the_kernel_ops(served):
    _, out, _ = served
    meta = json.loads((out / "serving_meta.json").read_text())
    assert meta["length_buckets"] == [BUCKET] and meta["max_spec"] == 512
    assert meta["stats_baked_in"] is False
    assert meta["buckets"][str(BUCKET)]["symbolic_batch"] is True
    program = torch.export.load(out / f"serving_P{BUCKET}.pt2")
    # K1 once, K2 once a transformer layer, K3f once a SpectraNet block
    assert _op_nodes(program) == {"seg_ids": 1, "masked_attention": 1, "ln_gelu_fwd": 2}


@pytest.mark.parametrize("n", [1, 4, 7])
def test_loaded_program_matches_live_and_jax(pair, loaded, n):
    task, params, model = pair
    samples = _samples(n)
    raw = ts.pack_alert_batch(samples, max_photo=BUCKET, max_spec=512)
    traw = {k: torch.from_numpy(v) for k, v in raw.items()}
    with torch.inference_mode():
        got = loaded(traw).numpy()
    live = ts.AlertStreamPipeline(model, wave_grid=GRID, device="cpu")(traw).numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)
    want = np.asarray(js.AlertStreamPipeline(task, wave_grid=GRID)(params, raw))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def _samples(n: int) -> list[dict]:
    """``n`` alerts of light curves up to ``BUCKET`` points, half with a
    spectrum of 20-700 points (past 512: decimated)."""
    return make_alert_samples(n, seed=11, spectrum_frac=0.5, length_range=(3, BUCKET),
                              spectrum_points=(20, 700))


def test_engine_serving_matches_live_serve(served, corpus):
    rt, out, live = served
    summary = rt.engine_serving(export_dir=out, raw_path=corpus, batch_size=4)
    assert summary["n_alerts"] == live["n_alerts"] > 0
    assert [(r["object_id"], r["jd"]) for r in summary["results"]] == \
        [(r["object_id"], r["jd"]) for r in live["results"]]
    np.testing.assert_allclose(_probs(summary), _probs(live), rtol=2e-5, atol=2e-6)


def test_engine_serving_runs_no_model_code(served, corpus, monkeypatch):
    rt, out, live = served

    def refuse(*args, **kwargs):
        raise AssertionError("engine_serving ran model code")

    monkeypatch.setattr(AppleCiderModule, "forward", refuse)
    monkeypatch.setattr(ts.ServingProgram, "forward", refuse)
    summary = rt.engine_serving(export_dir=out, raw_path=corpus, batch_size=4)
    np.testing.assert_allclose(_probs(summary), _probs(live), rtol=2e-5, atol=2e-6)


def test_engine_serving_takes_params(pair, served, corpus):
    """``params`` replaces the weights the programs carry."""
    rt, out, live = served
    cfg = load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32")]:
        cfg.set(k, v)
    other = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    got = rt.engine_serving(export_dir=out, raw_path=corpus, batch_size=4,
                            params=other.state_dict())
    want = serve_alert_stream(other, iter_alert_samples(corpus), batch_size=4,
                              length_buckets=(BUCKET,), wave_grid=GRID, device="cpu")
    np.testing.assert_allclose(_probs(got), _probs(want), rtol=2e-5, atol=2e-6)
    assert np.abs(_probs(got) - _probs(live)).max() > 1e-3


def test_engine_serving_concrete_fallback(pair, served, corpus, tmp_path, monkeypatch):
    """Where the symbolic export fails, the bucket is exported at
    ``serve.batch_size`` (4) rows: ``engine_serving`` pads a shorter batch
    to it, slices the pad off, and refuses a longer one."""
    _, _, model = pair
    rt, _, live = served

    def refuse(*args, **kwargs):
        raise RuntimeError("forced")

    monkeypatch.setattr(torch.export, "Dim", refuse)
    out = rt.export_serving(out_path=tmp_path / "exp", length_buckets=(BUCKET,),
                            params=model.state_dict(), wave_grid=GRID)
    bmeta = json.loads((out / "serving_meta.json").read_text())["buckets"][str(BUCKET)]
    assert bmeta["symbolic_batch"] is False and bmeta["batch_size"] == 4
    assert "forced" in bmeta["symbolic_error"]
    summary = rt.engine_serving(export_dir=out, raw_path=corpus, batch_size=3)
    assert summary["n_alerts"] == live["n_alerts"] and summary["n_alerts"] % 3
    np.testing.assert_allclose(_probs(summary), _probs(live), rtol=2e-5, atol=2e-6)
    with pytest.raises(ValueError, match="exceeds bucket P=32's concrete"):
        rt.engine_serving(export_dir=out, raw_path=corpus, batch_size=5)


@pytest.fixture(scope="module")
def trained(prepared, tmp_path_factory):  # noqa: F811
    """A workdir holding one trained run (1 epoch, batches of 4)."""
    workdir = tmp_path_factory.mktemp("export_results")
    rt = _runtime(prepared, workdir, **{"train/epochs": 1})
    rt.prepare()
    rt.train()
    return workdir


def _rt(prepared, workdir, batch_size=BATCH):  # noqa: F811
    rt = _runtime(prepared, workdir, **{"train/epochs": 1, "data_loader/batch_size": batch_size})
    rt.prepare()
    return rt


def test_export_engine_roundtrip(prepared, trained, tmp_path):  # noqa: F811
    rt = _rt(prepared, trained)
    export_dir = rt.export(tmp_path / "exp")
    assert (export_dir / "model.pt2").exists()
    assert json.loads((export_dir / "export_meta.json").read_text()) == \
        {"batch_size": BATCH, "symbolic_batch": True}
    program = torch.export.load(export_dir / "model.pt2")
    assert _op_nodes(program) == {"seg_ids": 0, "masked_attention": 1, "ln_gelu_fwd": 2}
    np.testing.assert_allclose(rt.engine(export_dir), rt.infer(), rtol=0, atol=1e-5)


def test_export_engine_ragged_tail_batch(prepared, trained, tmp_path):  # noqa: F811
    rt = _rt(prepared, trained, batch_size=5)
    n = len(rt.datasets["infer"])
    assert n > 5 and n % 5, n  # a tail batch shorter than the exported one
    export_dir = rt.export(tmp_path / "exp")
    meta = json.loads((export_dir / "export_meta.json").read_text())
    assert meta["batch_size"] == 5 and meta["symbolic_batch"] is True
    direct, via_engine = rt.infer(), rt.engine(export_dir)
    assert via_engine.shape == direct.shape == (n, 5)
    np.testing.assert_allclose(via_engine, direct, rtol=0, atol=1e-5)


def test_engine_pads_a_concrete_export(prepared, trained, tmp_path, monkeypatch):  # noqa: F811
    rt = _rt(prepared, trained, batch_size=5)

    def refuse(*args, **kwargs):
        raise RuntimeError("forced")

    monkeypatch.setattr(torch.export, "Dim", refuse)
    export_dir = rt.export(tmp_path / "exp")
    meta = json.loads((export_dir / "export_meta.json").read_text())
    assert meta["symbolic_batch"] is False and "forced" in meta["symbolic_error"]
    np.testing.assert_allclose(rt.engine(export_dir), rt.infer(), rtol=0, atol=1e-5)


def test_engine_ignores_serving_export_dirs(prepared, trained):  # noqa: F811
    rt = _rt(prepared, trained)
    export_dir = rt.export()  # a run directory of the workdir
    assert export_dir.parent == trained and "-export-AppleCider" in export_dir.name
    (trained / "zzzz-export-serving-AppleCider").mkdir()  # sorts after it
    np.testing.assert_allclose(rt.engine(), rt.infer(), rtol=0, atol=1e-5)


@pytest.mark.slow
def test_full_width_serving_program_matches_jax(tmp_path):
    """``export_serving`` at the published widths (f32) against the JAX
    ``AlertStreamPipeline`` with the same weights, on one packed batch of 3
    alerts at the longest length bucket (P = 257), within 1e-4."""
    jcfg = _fusion_task(tiny=False, compute_dtype="float32").config
    jcfg.set("model.SpectraNet.conv_mode", "direct")  # the JAX CPU router's FFT convs differ
    task = AppleCiderTask(jcfg)
    shapes = jax.eval_shape(lambda k: task.init(k, _fusion_batch(2)),
                            jax.random.PRNGKey(0))["params"]
    cfg = load_defaults()
    cfg.set("train.compute_dtype", "float32")
    drawn = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = _flax_params(shapes, drawn.state_dict())
    rt = AppleCiderRuntime(overrides={"model": {"name": "AppleCider"},
                                      "train": {"compute_dtype": "float32"}},
                           workdir=tmp_path / "results", device="cpu")
    out = rt.export_serving(out_path=tmp_path / "exp", length_buckets=(257,),
                            params=from_jax_params(params))
    program = torch.export.load(out / "serving_P257.pt2")
    assert _op_nodes(program) == {"seg_ids": 1, "masked_attention": 4, "ln_gelu_fwd": 5}
    samples = make_alert_samples(3, seed=11, spectrum_frac=0.5, length_range=(20, 257),
                                 spectrum_points=(80, 2000))
    raw = ts.pack_alert_batch(samples, max_photo=257)
    with torch.inference_mode():
        got = program.module()({k: torch.from_numpy(v) for k, v in raw.items()}).numpy()
    want = np.asarray(js.AlertStreamPipeline(task)(params, raw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
