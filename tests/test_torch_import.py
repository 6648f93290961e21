"""The PyTorch port imports without JAX or the JAX package, and its entry
points refuse to run without a GPU unless the CPU is asked for."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "applecider_tpu_torch",
    "applecider_tpu_torch.config",
    "applecider_tpu_torch.device",
    "applecider_tpu_torch.registry",
    "applecider_tpu_torch.ops.kernel",
    "applecider_tpu_torch.ops.merge_scan",
    "applecider_tpu_torch.ops.attention",
    "applecider_tpu_torch.ops.ln_gelu",
    "applecider_tpu_torch.ops.flash_attention",
    "applecider_tpu_torch.ops.flash_microab",
    "applecider_tpu_torch.ops.dropout",
    "applecider_tpu_torch.ops.losses",
    "applecider_tpu_torch.ops.conv1d",
    "applecider_tpu_torch.ops.moe",
    "applecider_tpu_torch.ops.metrics",
    "applecider_tpu_torch.ops.int8",
    "applecider_tpu_torch.ops.quant",
    "applecider_tpu_torch.parallel",
    "applecider_tpu_torch.parallel.mesh",
    "applecider_tpu_torch.parallel.multihost",
    "applecider_tpu_torch.models",
    "applecider_tpu_torch.models.layers",
    "applecider_tpu_torch.models.time2vec",
    "applecider_tpu_torch.models.base",
    "applecider_tpu_torch.models.baseline_cls",
    "applecider_tpu_torch.models.mpt",
    "applecider_tpu_torch.models.spectranet",
    "applecider_tpu_torch.models.convnext",
    "applecider_tpu_torch.models.astrominn",
    "applecider_tpu_torch.models.fusion",
    "applecider_tpu_torch.models.zoo",
    "applecider_tpu_torch.models.experimental",
    "applecider_tpu_torch.infer",
    "applecider_tpu_torch.infer.stream",
    "applecider_tpu_torch.infer.serve",
    "applecider_tpu_torch.infer.feeder",
    "applecider_tpu_torch.infer.cli",
    "applecider_tpu_torch.native",
    "applecider_tpu_torch.preprocessing",
    "applecider_tpu_torch.preprocessing.config",
    "applecider_tpu_torch.preprocessing.table",
    "applecider_tpu_torch.preprocessing.fitsio",
    "applecider_tpu_torch.preprocessing.photometry",
    "applecider_tpu_torch.preprocessing.spectra",
    "applecider_tpu_torch.preprocessing.builder",
    "applecider_tpu_torch.preprocessing.alert_samples",
    "applecider_tpu_torch.preprocessing.events",
    "applecider_tpu_torch.preprocessing.alerts",
    "applecider_tpu_torch.preprocessing.manifest",
    "applecider_tpu_torch.preprocessing.cli",
    "applecider_tpu_torch.utils",
    "applecider_tpu_torch.utils.weights",
    "applecider_tpu_torch.utils.observability",
    "applecider_tpu_torch.utils.rng",
    "applecider_tpu_torch.utils.torch_port",
    "applecider_tpu_torch.utils.import_checkpoint",
    "applecider_tpu_torch.utils.plots",
    "applecider_tpu_torch.datasets",
    "applecider_tpu_torch.datasets.loader",
    "applecider_tpu_torch.datasets.taxonomy",
    "applecider_tpu_torch.datasets.oversampler",
    "applecider_tpu_torch.datasets.photo_dataset",
    "applecider_tpu_torch.datasets.fusion_dataset",
    "applecider_tpu_torch.datasets.spectra_dataset",
    "applecider_tpu_torch.datasets.image_metadata_dataset",
    "applecider_tpu_torch.datasets.logit_sequence_dataset",
    "applecider_tpu_torch.train",
    "applecider_tpu_torch.train.optim",
    "applecider_tpu_torch.train.trainer",
    "applecider_tpu_torch.train.runtime",
    "applecider_tpu_torch.testing",
    "applecider_tpu_torch.tools",
    "applecider_tpu_torch.tools.profile_serving",
    "applecider_tpu_torch.tools.profile_training",
    "applecider_tpu_torch.tools.flash_microab",
    "applecider_tpu_torch.tools.kernel_timing",
    "applecider_tpu_torch.tools.host_overhead",
    "applecider_tpu_torch.tools.profile_tasks",
    "applecider_tpu_torch.tools.conv_routes",
    "applecider_tpu_torch.tools.learning_demo",
    "applecider_tpu_torch._lazy",
]


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter whose import
    system refuses ``jax``, ``flax``, ``applecider_tpu``, ``pandas`` and
    ``sklearn`` (the card's machine has neither pandas nor scikit-learn)."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "applecider_tpu", "pandas", "sklearn")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]
        sys.meta_path.insert(0, Block())
        for m in {MODULES!r}:
            importlib.import_module(m)
        leaked = [n for n in sys.modules if n.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# the JAX package's package-level and module-level public names, at the same
# paths in the port
PUBLIC_NAMES = {
    "": ["Config", "load_config", "get_model", "get_dataset_class", "register_model",
         "register_dataset"],
    ".preprocessing": ["PreprocessConfig", "build_all_preprocessed", "build_multimodal_for_object",
                       "make_splits_from_manifest", "compute_feature_stats", "find_available_ids",
                       "write_manifest_csv", "Config", "compute_feature_stats_safe"],
    ".train": ["Trainer", "AppleCiderRuntime"],
    ".ops": ["class_balanced_weights", "cross_entropy", "dice_loss", "focal_loss",
             "multiclass_bce_loss", "topk_dense_dispatch"],
    ".utils": ["seed_everything", "key_iter"],
    ".models.convnext": ["convnext_tiny"],
    ".infer.stream": ["resample_spectrum"],
}


def test_public_names_import_from_the_jax_paths_with_jax_blocked():
    """``from <port path> import <name>`` for every public name the JAX
    package exports at that path, in a fresh interpreter with the JAX
    package blocked; importing a package alone pulls in none of its
    submodules' heavy imports (the names resolve at first use)."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "applecider_tpu", "pandas", "sklearn")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        import applecider_tpu_torch.train, applecider_tpu_torch.preprocessing
        assert "applecider_tpu_torch.train.trainer" not in sys.modules
        assert "torch.distributed.nn" not in sys.modules
        for path, names in {PUBLIC_NAMES!r}.items():
            module = importlib.import_module("applecider_tpu_torch" + path)
            for name in names:
                exec(f"from applecider_tpu_torch{{path}} import {{name}}")
                assert name in dir(module), (path, name)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_public_names_are_the_port_objects():
    """The aliases and the thin names: ``Config`` of preprocessing is
    ``PreprocessConfig``; ``convnext_tiny`` is ConvNeXt-tiny; and
    ``resample_spectrum`` equals JAX's on unsorted spectra (one and a block)."""
    import jax.numpy as jnp

    from applecider_tpu.infer.stream import resample_spectrum as jax_resample
    from applecider_tpu_torch import preprocessing, train
    from applecider_tpu_torch.infer.stream import resample_spectrum
    from applecider_tpu_torch.models.convnext import ConvNeXt, convnext_tiny
    from applecider_tpu_torch.preprocessing.config import PreprocessConfig
    from applecider_tpu_torch.train.trainer import Trainer

    assert preprocessing.Config is preprocessing.PreprocessConfig is PreprocessConfig
    assert preprocessing.compute_feature_stats_safe is preprocessing.compute_feature_stats
    assert train.Trainer is Trainer
    m = convnext_tiny()
    assert isinstance(m, ConvNeXt) and m.depths == (3, 3, 9, 3)
    assert m.head_norm.weight.shape == (768,)
    rng = np.random.default_rng(0)
    grid = np.linspace(4500.0, 7980.0, 64, dtype=np.float32)
    wl = rng.uniform(4000, 8500, size=(3, 40)).astype(np.float32)  # unsorted
    flux = rng.normal(size=(3, 40)).astype(np.float32)
    valid = rng.random((3, 40)) > 0.2
    got = resample_spectrum(*map(torch.from_numpy, (wl, flux, valid)), grid).numpy()
    for i in range(3):
        want = np.asarray(jax_resample(jnp.asarray(wl[i]), jnp.asarray(flux[i]),
                                       jnp.asarray(valid[i]), jnp.asarray(grid)))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        one = resample_spectrum(*(torch.from_numpy(a[i]) for a in (wl, flux, valid)), grid)
        np.testing.assert_array_equal(one.numpy(), got[i])


def test_port_config_copies_the_published_widths():
    """The port's own default_config.toml holds the JAX package's values for
    every key it copies: from the JAX config file, or, for the keys that
    file leaves out, from the code's defaults (the flax AstroMiNN module's;
    ``AppleCiderTask.loss_fn``'s criterion "ce" and focal_gamma 2.0)."""
    import tomllib

    from applecider_tpu.models.astrominn import AstroMiNNModule
    from applecider_tpu_torch.config import load_defaults

    with open(REPO / "applecider_tpu" / "default_config.toml", "rb") as f:
        jax_cfg = tomllib.load(f)
    loss_fn_defaults = {"criterion": "ce", "focal_gamma": 2.0}
    port = load_defaults()
    for section in ("BaselineCLS", "SpectraNet", "AstroMiNN", "AppleCider"):
        for key, value in port["model"][section].items():
            want = jax_cfg["model"][section].get(key)
            if want is None and section == "AstroMiNN":
                want = getattr(AstroMiNNModule, key)
            if want is None and section == "AppleCider":
                want = loss_fn_defaults[key]
            assert value == (list(want) if isinstance(want, tuple) else want), (section, key)
    for section in ("train", "data_loader", "checkpoint"):
        for key, value in port[section].items():
            assert value == jax_cfg[section][key], (section, key)


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """With no usable GPU, the default device raises; ``device="cpu"`` runs."""
    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.device import resolve_device
    from applecider_tpu_torch.infer.serve import serve_alert_stream
    from applecider_tpu_torch.infer.stream import (
        AlertStreamPipeline, FusedSpectraStream, LengthBinnedFeeder, RoutedAlertStream,
    )
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.astrominn import AstroMiNNTask
    from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
    from applecider_tpu_torch.models.fusion import AppleCiderTask
    from applecider_tpu_torch.models.mpt import MPTTask
    from applecider_tpu_torch.models.spectranet import SpectraNetTask, SpectraNetTriPoolTask
    from applecider_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_defaults()
    for k, v in [("model.BaselineCLS.d_model", 8), ("model.BaselineCLS.n_heads", 1),
                 ("model.BaselineCLS.n_layers", 1), ("model.SpectraNet.channels", [2]),
                 ("model.SpectraNet.depths", [1]), ("model.SpectraNet.kernel_sizes_per_stage", [[3]]),
                 ("model.AstroMiNN.backbone_depths", [1]), ("model.AstroMiNN.backbone_dims", [4])]:
        cfg.set(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_fusion_model(cfg)
    model = build_fusion_model(cfg, device="cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AlertStreamPipeline(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FusedSpectraStream(model)
    stream = FusedSpectraStream(model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LengthBinnedFeeder(stream)
    LengthBinnedFeeder(stream, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RoutedAlertStream(model)
    RoutedAlertStream(model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_alert_stream(model, iter([]))
    assert serve_alert_stream(model, iter([]), device="cpu")["n_alerts"] == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(AppleCiderTask(cfg, model), cfg, REPO / "build" / "unused")
    for task_cls in (BaselineCLSTask, MPTTask, SpectraNetTask, SpectraNetTriPoolTask,
                     AstroMiNNTask):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            task_cls(cfg)
        task = task_cls(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(task, cfg, REPO / "build" / "unused")
    from applecider_tpu_torch.models.zoo import ZOO
    from applecider_tpu_torch.registry import get_model

    batch = (np.zeros((2, 32, 32, 3), np.float32), np.zeros(2, np.int64))
    for name in ZOO:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model(name)(cfg)
    task = get_model("SpectraConvNeXt")(
        cfg.merged_with({"model": {"SpectraConvNeXt": {"depths": [1], "dims": [4]}}}), device="cpu")
    assert next(task.init(batch).parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(task, cfg, REPO / "build" / "unused")


def test_kernel_wrappers_take_cpu_or_cuda_only():
    """On a CPU tensor a wrapper runs its plain version; any other device
    is refused rather than routed to the plain version."""
    from applecider_tpu_torch.ops import attention, ln_gelu, merge_scan

    t = torch.zeros((2, 4))
    band = torch.zeros((2, 4), dtype=torch.int32)
    valid = torch.ones((2, 4), dtype=torch.bool)
    assert merge_scan.seg_ids(t, band, valid).dtype == torch.int32
    with pytest.raises(ValueError, match="CUDA tensors"):
        merge_scan.seg_ids(t.to("meta"), band.to("meta"), valid.to("meta"))
    q = torch.zeros((1, 1, 3, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        attention.masked_attention(q.to("meta"), q.to("meta"), q.to("meta"), None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_gelu.ln_gelu(q.to("meta"), torch.ones(8, device="meta"), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ln_gelu.ln_gelu_backward(q.to("meta"), torch.ones(8, device="meta"),
                                 torch.zeros(8, device="meta"), q.to("meta"))
    from applecider_tpu_torch.ops import flash_attention

    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"), None, 1, 0.4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention.flash_backward(q.to("meta"), q.to("meta"), q.to("meta"), None, 0.4,
                                       q.to("meta"), seed=1)
    from applecider_tpu_torch.models.layers import Linear
    from applecider_tpu_torch.ops import int8, quant

    assert int8.quantize(t, 1.0).dtype == torch.int8
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8.quantize(t.to("meta"), 1.0)
    a = torch.zeros((3, 8), dtype=torch.int8)
    assert int8.gemm(a, a, None, None, torch.int32).dtype == torch.int32
    with pytest.raises(ValueError, match="CUDA tensors"):
        int8.gemm(a.to("meta"), a.to("meta"), None, None, torch.int32)
    x = torch.zeros((1, 5, 5, 4), dtype=torch.int8)
    for w, groups in ((torch.zeros((4, 4, 3, 3), dtype=torch.int8), 1),
                      (torch.zeros((4, 1, 3, 3), dtype=torch.int8), 4)):
        assert int8.conv2d(x, w, None, None, torch.int32, groups=groups).shape == (1, 3, 3, 4)
        with pytest.raises(ValueError, match="CUDA tensors"):
            int8.conv2d(x.to("meta"), w.to("meta"), None, None, torch.int32, groups=groups)
    with quant.quantized({"": 1.0}), pytest.raises(ValueError, match="CUDA tensors"):
        Linear(8, 4).to("meta")(torch.zeros((2, 8), device="meta"))
