"""The port's user-facing scripts on the CPU at their smallest sizes:
``docs/examples/torch_*.py`` (the port's copies of the JAX examples, which
import only ``applecider_tpu_torch``) and the learning demo's library entry
(``applecider_tpu_torch/tools/learning_demo.py``), which at a few objects
and one epoch learns nothing but writes every artifact."""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_fusion_quickstart", "torch_serve_quickstart", "torch_sweep")
STDLIB = {"__future__", "argparse", "sys", "tempfile", "pathlib"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_example_{name}",
                                                  REPO / "docs" / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    tree = ast.parse((REPO / "docs" / "examples" / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots <= STDLIB | {"applecider_tpu_torch", "numpy", "torch", "optuna"}, roots
    assert "applecider_tpu_torch" in roots


def test_torch_quickstart_on_the_cpu(tmp_path):
    out = _load("torch_quickstart").main(tmp_path, device="cpu")
    assert out["pretrain"] and out["train"]
    np.testing.assert_allclose(out["probs"].sum(-1), 1.0, atol=1e-4)
    assert (out["export_dir"] / "model.pt2").exists()


def test_torch_fusion_quickstart_on_the_cpu(tmp_path):
    out = _load("torch_fusion_quickstart").main(tmp_path, device="cpu")
    assert len(out["history"]) == 2 and all(np.isfinite(h["train_loss"]) for h in out["history"])
    assert out["probs"].shape == (4, 5)


def test_torch_serve_quickstart_on_the_cpu(tmp_path):
    summary = _load("torch_serve_quickstart").main(tmp_path, device="cpu")
    assert summary["n_alerts"] == 36  # 6 objects x 6 alerts
    lines = (tmp_path / "alerts.jsonl").read_text().splitlines()
    assert len(lines) == 36
    probs = np.stack([r["probs"] for r in summary["results"]])
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)


def test_torch_sweep_on_the_cpu(tmp_path):
    score, params = _load("torch_sweep").main(tmp_path, device="cpu", n_trials=2)
    assert 0.0 <= score <= 1.0 and set(params) == {"lr", "dropout", "d_model"}


def test_learning_demo_writes_every_artifact(tmp_path):
    from applecider_tpu_torch.tools.learning_demo import run

    summary = run(tmp_path / "demo", seeds=1, n_objects=20, epochs=1, device="cpu", mpt_epochs=1,
                  log=lambda m: None)
    files = sorted(p.name for p in (tmp_path / "demo").iterdir())
    assert files == ["confusion_fusion.png", "metrics_seed0.jsonl", "summary.json"]
    on_disk = json.loads((tmp_path / "demo" / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    for key in ("photo_warm_accuracy", "photo_cold_accuracy", "fusion_accuracy",
                "majority_fraction"):
        assert summary[key]["n"] == 1 and 0.0 <= summary[key]["mean"] <= 1.0, key
    seed = summary["per_seed"][0]
    assert len(seed["mpt_losses"]) == 1 and seed["seconds"] > 0
    assert np.asarray(seed["fusion_confusion"]).shape == (5, 5)
    history = [json.loads(x) for x in
               (tmp_path / "demo" / "metrics_seed0.jsonl").read_text().splitlines()]
    assert history == seed["fusion_history"] and len(history) == 1
