"""Weights trained elsewhere, brought into the port.

* The reference's PyTorch checkpoints (``utils/import_checkpoint.py``,
  ``utils/torch_port.py``): each family's ``tests/torch_refs.py`` oracle
  imported into the port gives its logits within 1e-4 in f32; the imported
  state_dict equals ``from_jax_params`` of the JAX package's own converter
  on the same dict, exactly, for every family and layout (the reference's
  ``nn.Sequential`` names, timm's ConvNeXt names and TriPool's BatchNorm
  statistics, on dicts laid out from the port's own modules); both
  packages' ``rename_reference_*_sd`` agree; an imported MPT warm-starts
  the classifier as the JAX ``mpt_to_classifier_warmstart`` does.
* A JAX run (``scripts/convert_jax_checkpoint.py``): the JAX ``Trainer``
  on ``test_torch_trainer_options.py``'s BaselineCLS harness with EMA and
  the plateau on, converted after epoch 1 and resumed in the port, matches
  the JAX run's epoch 2 at ``test_fit_matches_jax``'s tolerances; an
  unmapped optimizer layout raises, and ``params_only`` still carries the
  weights over.
"""

import importlib.util
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from applecider_tpu.datasets.loader import DataLoader as JaxDataLoader
from applecider_tpu.datasets.photo_dataset import PhotoEventsDataset as JaxPhotoEventsDataset
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu.train.trainer import Trainer as JaxTrainer
from applecider_tpu.utils import torch_port as jax_port
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
from applecider_tpu_torch.models.mpt import MPTTask
from applecider_tpu_torch.models.spectranet import SpectraNetTriPoolTask
from applecider_tpu_torch.train.runtime import AppleCiderRuntime
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils import import_checkpoint as importer
from applecider_tpu_torch.utils import torch_port
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_archive_parity import REF
from tests.test_torch_trainer_options import BATCH, D_MODEL, LR, _cfgs, _init_params, data  # noqa: F401
from tests.torch_refs import (
    TorchAppleCider, TorchAstroMiNN, TorchBaselineCLS, TorchMPT, TorchSpectraNet, state_dict_numpy,
)

REPO = Path(__file__).resolve().parents[1]
PHOTO = {"d_model": 16, "n_heads": 2, "n_layers": 2}
SPEC = {"channels": [4, 8], "depths": [1, 1], "kernel_sizes_per_stage": [[3, 7], [3, 5]]}
BACKBONE = {"backbone_depths": [1, 1], "backbone_dims": [8, 16]}
TRIPOOL = {"channels": [2, 2, 2, 2, 2], "use_ln_stages": [False, True, False, True, True]}
SPEC_BINS = 1024  # TriPool's head reads the whole length: 1024 // 4**4 = 4


def _cfg(**model):
    cfg = load_defaults()
    cfg.set("train.compute_dtype", "float32")
    for section, values in {"BaselineCLS": PHOTO, "SpectraNet": SPEC, "AstroMiNN": BACKBONE,
                            "SpectraNetTriPool": TRIPOOL, **model}.items():
        for k, v in values.items():
            cfg.set(f"model.{section}.{k}", v)
    cfg.set('data_set."applecider_tpu.datasets.spectra_dataset.SpectraDataset".n_bins',
            SPEC_BINS)
    return cfg


def _oracles():
    """(model name, oracle in eval mode, its inputs as NumPy) per family."""
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    B, L = 3, 12
    photo = rng.normal(size=(B, L, 7)).astype(np.float32)
    pad = np.arange(L)[None, :] >= np.array([L, 7, 3])[:, None]
    meta = rng.normal(size=(B, 24)).astype(np.float32)
    image = rng.normal(size=(B, 3, 63, 63)).astype(np.float32)
    spectra = rng.normal(size=(B, 256)).astype(np.float32)
    kernels = SPEC["kernel_sizes_per_stage"]
    fusion = TorchAppleCider(
        TorchBaselineCLS(**PHOTO, dropout=0.0, classification=False),
        TorchSpectraNet(SPEC["channels"], SPEC["depths"], kernels, num_classes=9, embedding=True),
        TorchAstroMiNN(backbone_dims=(8, 16), backbone_depths=(1, 1)), spectra_hidden=384)
    return {
        "BaselineCLS": (TorchBaselineCLS(**PHOTO, dropout=0.0), (photo, pad)),
        "MPT": (TorchMPT(**PHOTO, dropout=0.0), (photo, pad)),
        "SpectraNet": (TorchSpectraNet(SPEC["channels"], SPEC["depths"], kernels, num_classes=9),
                       (spectra,)),
        "AstroMiNN": (TorchAstroMiNN(backbone_dims=(8, 16), backbone_depths=(1, 1)),
                      (meta, image)),
        "AppleCider": (fusion, (photo, pad, meta, image, spectra)),
    }


def _port_inputs(inputs):
    """The oracle's inputs as the port's module takes them (images NHWC)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a.transpose(0, 2, 3, 1) if a.ndim == 4 else a)) for a in inputs)


ORACLES = ["BaselineCLS", "MPT", "SpectraNet", "AstroMiNN", "AppleCider"]


@pytest.mark.parametrize("model", ORACLES)
def test_imported_oracle_logits(model):
    oracle, inputs = _oracles()[model]
    oracle.eval()
    with torch.no_grad():
        want = oracle(*(torch.from_numpy(a) for a in inputs))
    cfg = _cfg()
    state = importer.import_checkpoint(oracle.state_dict(), model, cfg)
    module = importer.fresh_module(model, cfg)
    module.load_state_dict(state, strict=True)
    module.eval()
    with torch.no_grad():
        got = module(*_port_inputs(inputs))
    if model == "MPT":  # the oracle's heads keep a trailing axis of 1
        want = torch.cat([want[0], want[1], want[2]], dim=-1)
        got = torch.cat([got[0][..., None], got[1], got[2][..., None]], dim=-1)
        valid = ~torch.from_numpy(inputs[1])
        want, got = want[valid], got[valid]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


# ------------------------------------------------- reference-layout dicts
_LAYER = [(r"trunk\.encoder\.layer_(\d+)\.self_attn\.in_proj\.(weight|bias)",
           r"encoder.layers.\1.self_attn.in_proj_\2"),
          (r"trunk\.encoder\.layer_(\d+)\.", r"encoder.layers.\1."), (r"trunk\.", "")]
_TRIPOOL = [(r"stage(\d+)_block(\d+)\.conv_(\d+)\.",
             lambda m: f"stage{int(m[1]) + 1}.{m[2]}.convs.{m[3]}."),
            (r"stage(\d+)_block(\d+)\.", lambda m: f"stage{int(m[1]) + 1}.{m[2]}."),
            (r"head_fc1\.", "class_model.0."), (r"head_norm1\.", "class_model.1."),
            (r"head_fc2\.", "class_model.4."), (r"head_norm2\.", "class_model.5.")]
_TOWER = [(r"\.start\.", ".start_path.0."), (r"\.gate_norm\.", ".activation.0."),
          (r"\.gate_fc\.", ".activation.2."), (r"\.main_norm\.", ".main_path.0."),
          (r"\.main_fc\.", ".main_path.2."), (r"\.skip\.", ".skip_path.")]
_ASTROMINN = [(r"^expert_(\d+)\.", r"fusion_experts.\1."), (r"^router_fc1\.", "fusion_router.0."),
              (r"^router_fc2\.", "fusion_router.3."),
              (r"^image_tower\.main_norm\.", "image_tower.head_main.1."),
              (r"^image_tower\.main_fc1\.", "image_tower.head_main.2."),
              (r"^image_tower\.main_fc2\.", "image_tower.head_main.5."),
              (r"^image_tower\.main_fc3\.", "image_tower.head_main.6."),
              (r"^image_tower\.aux_norm\.", "image_tower.head_aux.0."),
              (r"^image_tower\.aux_fc\.", "image_tower.head_aux.1.")]
_TIMM = [(r"stem_conv\.", "stem.0."), (r"stem_norm\.", "stem.1."),
         (r"downsample(\d+)_norm\.", r"stages.\1.downsample.0."),
         (r"downsample(\d+)_conv\.", r"stages.\1.downsample.1."),
         (r"stage(\d+)_block(\d+)\.dwconv\.", r"stages.\1.blocks.\2.conv_dw."),
         (r"stage(\d+)_block(\d+)\.pwconv1\.", r"stages.\1.blocks.\2.mlp.fc1."),
         (r"stage(\d+)_block(\d+)\.pwconv2\.", r"stages.\1.blocks.\2.mlp.fc2."),
         (r"stage(\d+)_block(\d+)\.", r"stages.\1.blocks.\2."), (r"head_norm\.", "head.norm.")]


def _rename(name: str, rules) -> str:
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _astrominn_ref_name(name: str) -> str:
    """A port AstroMiNN name in XastroMiNN's Sequential names, the
    backbone in timm's."""
    if name.startswith("image_tower.backbone."):
        return "image_tower.backbone." + _rename(name[len("image_tower.backbone."):], _TIMM)
    name = _rename(name, _ASTROMINN)
    if not name.startswith("image_tower."):
        name = _rename(name, _TOWER)
    return name


def _reference_dict(module, rename, seed=1) -> dict:
    """A reference-layout state_dict of random f32 arrays, shaped as the
    port module's entries and named by ``rename``."""
    rng = np.random.default_rng(seed)
    return {rename(n): rng.normal(size=t.shape).astype(np.float32)
            for n, t in module.state_dict().items()}


def _fusion_ref_name(name: str) -> str:
    head, rest = name.split(".", 1) if "." in name else (name, "")
    if head == "photometry_encoder":
        return f"{head}.{_rename(rest, _LAYER)}"
    if head == "spectra_encoder":
        return f"{head}.{_rename(rest, _TRIPOOL)}"
    if head == "img_meta_encoder":
        return f"img_metadata_encoder.{_astrominn_ref_name(rest)}"
    return name


def _same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


def test_every_family_equals_the_jax_converter():
    """For each family and layout: the port's state_dict ==
    from_jax_params(the JAX converter's params), exactly."""
    cfg = _cfg()
    oracles = _oracles()
    np_sd = {m: state_dict_numpy(o) for m, (o, _) in oracles.items()}
    kernels = [len(k) for k in SPEC["kernel_sizes_per_stage"]]
    _same(torch_port.baseline_cls_sd(np_sd["BaselineCLS"], 2),
          from_jax_params(jax_port.baseline_cls_params(np_sd["BaselineCLS"], 2)))
    _same(torch_port.mpt_sd(np_sd["MPT"], 2), from_jax_params(jax_port.mpt_params(np_sd["MPT"], 2)))
    _same(torch_port.spectranet_sd(np_sd["SpectraNet"], SPEC["depths"], kernels),
          from_jax_params(jax_port.spectranet_params(np_sd["SpectraNet"], SPEC["depths"], kernels)))
    _same(torch_port.astrominn_sd(np_sd["AstroMiNN"], (1, 1)),
          from_jax_params(jax_port.astrominn_params(np_sd["AstroMiNN"], (1, 1))))
    backbone = {k[len("image_tower.backbone."):]: v for k, v in np_sd["AstroMiNN"].items()
                if k.startswith("image_tower.backbone.")}
    _same(torch_port.convnext_sd(backbone, (1, 1)),
          from_jax_params(jax_port.convnext_params(backbone, (1, 1))))
    # the fusion embedding has no SpectraNet head_fc2: the JAX tree's only extra
    want = from_jax_params(jax_port.fusion_params(
        np_sd["AppleCider"], photometry_layers=2, spectranet_depths=SPEC["depths"],
        spectranet_kernels_per_stage=kernels, astrominn_backbone_depths=(1, 1)))
    got = torch_port.fusion_sd(np_sd["AppleCider"], photometry_layers=2,
                               spectranet_depths=SPEC["depths"],
                               spectranet_kernels_per_stage=kernels,
                               astrominn_backbone_depths=(1, 1))
    assert set(want) - set(got) == {"spectra_encoder.head_fc2.weight",
                                    "spectra_encoder.head_fc2.bias"}
    _same(got, {k: v for k, v in want.items() if k in got})
    assert importer.convert(np_sd["AppleCider"], "AppleCider", cfg).keys() == got.keys()

    # the reference's own layouts, laid out from the port's modules
    tripool = SpectraNetTriPoolTask(cfg, device="cpu").module
    ref = _reference_dict(tripool, lambda n: _rename(n, _TRIPOOL))
    params, stats = jax_port.spectranet_tripool_params(ref, [1] * 5, TRIPOOL["use_ln_stages"])
    got = importer.import_checkpoint(ref, "SpectraNetTriPool", cfg)
    _same(got, from_jax_params(params, stats))
    assert "stage0_block0.norm.running_var" in got and "stage1_block0.norm.running_var" not in got

    fusion_cfg = _cfg(AppleCider={"spectra_encoder": "tripool"})
    fusion = build_fusion_model(fusion_cfg, device="cpu")
    ref = _reference_dict(fusion, _fusion_ref_name)
    assert any(k.startswith("img_metadata_encoder.fusion_experts.0.start_path.0.") for k in ref)
    assert "img_metadata_encoder.image_tower.backbone.stages.1.blocks.0.conv_dw.weight" in ref
    got = importer.import_checkpoint(ref, "AppleCider", fusion_cfg)
    for name, t in fusion.state_dict().items():  # a round trip of every entry
        assert torch.equal(got[name], torch.from_numpy(ref[_fusion_ref_name(name)])), name
    # the JAX converter takes the backbone in the canonical layout, not timm's
    prefix = "img_metadata_encoder.image_tower.backbone."
    canonical = {k: v for k, v in ref.items() if not k.startswith(prefix)}
    canonical.update({prefix + k: v for k, v in torch_port.rename_timm_convnext_sd(
        {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}).items()})
    params, stats = jax_port.fusion_reference_params(
        canonical, photometry_layers=2, astrominn_backbone_depths=(1, 1))
    _same(got, from_jax_params(params, stats))


def test_reference_renames_match_the_jax_package():
    """Both packages' renames of the reference's ``nn.Sequential`` names
    give the same dict on the same real-layout input; the port's timm
    rename equals the goldens script's."""
    rng = np.random.default_rng(4)
    astro = build_fusion_model(_cfg(), device="cpu").img_meta_encoder
    sd = _reference_dict(astro, _astrominn_ref_name)
    got, want = torch_port.rename_reference_astrominn_sd(sd), jax_port.rename_reference_astrominn_sd(sd)
    assert list(got) == list(want) and all(got[k] is want[k] for k in want)
    spec = {f"stage{s}.0.convs.{i}.weight": rng.normal(size=(2, 1, 3)) for s in (1, 2)
            for i in range(3)}
    spec["classifier.0.weight"] = rng.normal(size=(4, 2))
    assert torch_port.rename_reference_spectranet_sd(spec) == \
        jax_port.rename_reference_spectranet_sd(spec)
    spec_mod = importlib.util.spec_from_file_location(
        "make_timm_goldens", REPO / "scripts" / "make_timm_goldens.py")
    goldens = importlib.util.module_from_spec(spec_mod)
    spec_mod.loader.exec_module(goldens)
    timm = {k[len("image_tower.backbone."):]: v for k, v in sd.items()
            if k.startswith("image_tower.backbone.")}
    assert torch_port.rename_timm_convnext_sd(timm) == goldens.rename_timm_convnext_sd(timm)


def test_mpt_import_then_warm_start_equals_jax():
    oracle, _ = _oracles()["MPT"]
    sd = state_dict_numpy(oracle)
    cfg = _cfg()
    mpt = importer.import_checkpoint(sd, "MPT", cfg)
    classifier = BaselineCLSTask(cfg, device="cpu").module.state_dict()
    got = torch_port.mpt_to_classifier_warmstart(classifier, mpt)
    want = from_jax_params(jax_port.mpt_to_classifier_warmstart(jax_port.mpt_params(sd, 2)))
    assert got.keys() == classifier.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k] if k.startswith("trunk.") else classifier[k]), k
    assert {k for k in got if k.startswith("trunk.")} == set(want)


def test_importer_cli_writes_what_the_runtime_reads(tmp_path):
    """``main`` writes ``checkpoints/best.pt`` that ``restore_weights``
    loads; ``--workdir`` makes a run the runtime takes as its latest; a
    config that builds another model fails naming the differing entries."""
    oracle, inputs = _oracles()["BaselineCLS"]
    torch.save({"state_dict": oracle.state_dict()}, tmp_path / "ref.pt")
    toml = tmp_path / "run.toml"
    toml.write_text("[model.BaselineCLS]\nd_model = 16\nn_heads = 2\nn_layers = 2\n"
                    "[train]\ncompute_dtype = \"float32\"\n")
    path = importer.main(["--model", "BaselineCLS", "--ckpt", str(tmp_path / "ref.pt"),
                          "--out", str(tmp_path / "run"), "--config", str(toml)])
    assert path == tmp_path / "run" / "checkpoints" / "best.pt"
    cfg = _cfg()
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, tmp_path / "run", device="cpu")
    assert trainer.restore_weights() == "best"
    with torch.no_grad():
        got = trainer.task.predict(_port_inputs(inputs))
        want = oracle.eval()(*(torch.from_numpy(a) for a in inputs))
    assert float((got - want).abs().max()) <= 1e-4

    importer.main(["--model", "BaselineCLS", "--ckpt", str(tmp_path / "ref.pt"),
                   "--workdir", str(tmp_path / "results"), "--config", str(toml)])
    rt = AppleCiderRuntime(toml, workdir=tmp_path / "results", device="cpu")
    latest = rt._latest_run_dir()
    assert latest.name.endswith("-train-BaselineCLS")
    assert (latest / "checkpoints" / "best.pt").exists()

    for old, new, named in (
            ("d_model = 16", "d_model = 32",
             "misshapen (32): fc.weight: (5, 16) (the config builds (5, 32))"),
            ("n_layers = 2", "n_layers = 1",
             "reads no entry of the checkpoint named (12): encoder.layers.1.linear1.bias"),
            ("n_layers = 2", "n_layers = 3", "missing key 'encoder.layers.2.self_attn.in_proj_weight'")):
        (tmp_path / "bad.toml").write_text(toml.read_text().replace(old, new))
        with pytest.raises(SystemExit) as err:
            importer.main(["--model", "BaselineCLS", "--ckpt", str(tmp_path / "ref.pt"),
                           "--out", str(tmp_path / "bad"), "--config", str(tmp_path / "bad.toml")])
        assert named in str(err.value)
    assert not (tmp_path / "bad").exists()
    with pytest.raises(SystemExit, match="does not look like a SpectraNet"):
        importer.main(["--model", "SpectraNet", "--ckpt", str(tmp_path / "ref.pt"),
                       "--out", str(tmp_path / "bad"), "--config", str(toml)])


@pytest.mark.skipif(not REF.exists(), reason="reference repo not mounted")
def test_reference_baseline_cls_imports(tmp_path):
    """The reference's own BaselineCLS module (its random init) imported
    through the CLI: logits within 1e-4 at the published widths."""
    from tests.test_archive_parity import _import_ref, cpu_patched_torch

    mod = _import_ref("_archive/AppleCider/models/BaselineCLS.py", "ref_bcls_torch_port")
    rng = np.random.default_rng(0)
    with cpu_patched_torch():
        ref = mod.BaselineCLS(d_model=128, n_heads=8, n_layers=4, num_classes=5, dropout=0.4,
                              mode="photo").eval()
        torch.save(ref.state_dict(), tmp_path / "ref.pt")
        x = rng.normal(size=(2, 257, 7)).astype(np.float32)
        pad = np.zeros((2, 257), bool)
        pad[:, 180:] = True
        with torch.no_grad():
            want = ref(torch.from_numpy(x), torch.from_numpy(pad))
    toml = tmp_path / "run.toml"
    toml.write_text("[train]\ncompute_dtype = \"float32\"\n")
    importer.main(["--model", "BaselineCLS", "--ckpt", str(tmp_path / "ref.pt"),
                   "--out", str(tmp_path / "run"), "--config", str(toml)])
    cfg = load_defaults()
    cfg.set("train.compute_dtype", "float32")
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, tmp_path / "run", device="cpu")
    trainer.restore_weights()
    with torch.no_grad():
        got = trainer.task.predict((torch.from_numpy(x), torch.from_numpy(pad)))
    assert float((got - want).abs().max()) <= 1e-4


# ------------------------------------------------------ a JAX run carried on
def _converter():
    spec = importlib.util.spec_from_file_location(
        "convert_jax_checkpoint", REPO / "scripts" / "convert_jax_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def _jax_fit(data, workdir, epochs, options):
    (jcfg, _), (jvcfg, _) = _cfgs(data, **options), _cfgs(data, "val", **options)
    trainer = JaxTrainer(JaxBaselineCLSTask(jcfg), jcfg, workdir)
    out = trainer.fit(
        JaxDataLoader(JaxPhotoEventsDataset(jcfg), batch_size=BATCH, shuffle=False),
        JaxDataLoader(JaxPhotoEventsDataset(jvcfg), batch_size=BATCH, shuffle=False),
        epochs=epochs, init_params=_init_params(data))
    return trainer, out


def _port_fit(data, workdir, epochs, options):
    (_, cfg), (_, vcfg) = _cfgs(data, **options), _cfgs(data, "val", **options)
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, workdir, device="cpu")
    res = trainer.fit(DataLoader(PhotoEventsDataset(cfg), batch_size=BATCH, shuffle=False),
                      DataLoader(PhotoEventsDataset(vcfg), batch_size=BATCH, shuffle=False),
                      epochs=epochs)
    return trainer, res


def _close(got: dict, want: dict, updates: int) -> None:
    """``test_fit_matches_jax``'s tolerances."""
    key_bias = slice(D_MODEL, 2 * D_MODEL)
    assert got.keys() == want.keys()
    for name, w in want.items():
        g, w = got[name].numpy().copy(), w.numpy().copy()
        if name.endswith("self_attn.in_proj.bias"):
            assert np.abs(g[key_bias] - w[key_bias]).max() <= 2 * LR * updates, name
            g[key_bias] = w[key_bias] = 0.0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def test_converted_jax_run_resumes_in_the_port(data, tmp_path):  # noqa: F811
    options = {"ema_decay": 0.9, "plateau_factor": 0.5, "plateau_patience": 0}
    whole, whole_out = _jax_fit(data, tmp_path / "whole", 2, options)
    _jax_fit(data, tmp_path / "split", 1, options)
    conv = _converter()
    cfg = _cfgs(data, **options)[1]
    state = conv.convert(tmp_path / "split", cfg, "last")
    assert state["epoch"] == 0 and state["step"] == 3 and len(state["plateau"]) == 3
    torch.save(state, tmp_path / "split" / "checkpoints" / "last.pt")
    trainer, res = _port_fit(data, tmp_path / "split", 2, options)
    assert [r["epoch"] for r in res["history"]] == [1] and trainer.step == 6
    updates = int(trainer.optimizer.state_dict()["state"][0]["step"])
    assert updates == 6
    _close(trainer.model.state_dict(), from_jax_params(
        jax.tree.map(np.asarray, whole_out["state"].params)), updates)
    _close(trainer.ema.shadow, from_jax_params(jax.tree.map(np.asarray, whole.ema.shadow)), updates)
    g, w = res["history"][0], whole_out["history"][1]
    for k in (k for k in w if k.startswith("val_")):
        assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])
    assert abs(g["last_grad_norm"] - w["last_grad_norm"]) <= 1e-5 * w["last_grad_norm"]
    assert g["lr_scale"] == w["lr_scale"]


def test_params_only_carries_an_unmapped_layout(data, tmp_path):  # noqa: F811
    """``optax.MultiSteps`` (``train.grad_accum_steps``) has no place in
    the port's optimizer state: the converter names it, and with
    ``params_only`` writes a checkpoint that ``restore_weights`` loads and
    ``fit`` resumes with a fresh optimizer."""
    options = {"grad_accum_steps": 2}
    _, out = _jax_fit(data, tmp_path, 1, options)
    conv = _converter()
    cfg = _cfgs(data, **options)[1]
    with pytest.raises(conv.UnmappedOptState, match="MultiSteps"):
        conv.convert(tmp_path, cfg, "last")
    state = conv.convert(tmp_path, cfg, "last", params_only=True)
    assert "opt_state" not in state
    torch.save(state, tmp_path / "checkpoints" / "last.pt")
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu"), cfg, tmp_path, device="cpu")
    assert trainer.restore_weights() == "last"
    want = from_jax_params(jax.tree.map(np.asarray, out["state"].params))
    assert all(torch.equal(trainer.model.state_dict()[k], v) for k, v in want.items())
    _, res = _port_fit(data, tmp_path, 2, options)
    assert [r["epoch"] for r in res["history"]] == [1]


def test_converter_maps_astrominn_groups(tmp_path):
    """AstroMiNN's 11 ``multi_transform`` AdamW states, after one optax
    update with each gradient equal to its parameter, become the port
    optimizer's state: every parameter of every group has ``step`` 1,
    ``exp_avg`` = (1 - b1) * p and ``exp_avg_sq`` = (1 - b2) * p**2 of
    its own group's betas."""
    import orbax.checkpoint as ocp

    from applecider_tpu.models.astrominn import AstroMiNNTask as JaxAstroMiNNTask
    from applecider_tpu_torch.models.astrominn import AstroMiNNTask
    from tests.test_torch_astrominn import _batch as astro_batch, _cfgs as astro_cfgs
    from tests.test_torch_pipeline import _flax_params

    jcfg, cfg = astro_cfgs()
    cfg.set("model.name", "AstroMiNN")
    jtask = JaxAstroMiNNTask(jcfg)
    meta, img, _ = astro_batch(0)
    shapes = jax.eval_shape(lambda k: jtask.init(k, (meta, img)), jax.random.PRNGKey(0))
    port = AstroMiNNTask(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = _flax_params(shapes["params"], port.module.state_dict())
    tx = jtask.make_optimizer()
    _, opt_state = tx.update(params, tx.init(params), params)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((tmp_path / "checkpoints" / "last").absolute(),
               {"params": params, "opt_state": opt_state, "step": np.asarray(1),
                "epoch": np.asarray(0)})
    ckptr.wait_until_finished()
    state = _converter().convert(tmp_path, cfg, "last")
    optimizer = port.make_optimizer(list(port.module.parameters()))
    optimizer.load_state_dict(state["opt_state"])
    assert len(optimizer.param_groups) == 11
    names = {id(p): n for n, p in port.module.named_parameters()}
    seen = 0
    for group in optimizer.param_groups:
        b1, b2 = group["betas"]
        for p in group["params"]:
            st, w = optimizer.state[p], p.detach()
            assert float(st["step"]) == 1.0, names[id(p)]
            torch.testing.assert_close(st["exp_avg"], (1 - b1) * w, rtol=1e-6, atol=1e-9)
            torch.testing.assert_close(st["exp_avg_sq"], (1 - b2) * w * w, rtol=1e-5, atol=1e-12)
            seen += 1
    assert seen == len(names)


# ------------------------------------- TriPool's norm layout, from the checkpoint
TRI_LAYOUT = [False, True, False]  # BatchNorm, LayerNorm, BatchNorm


def _tripool_fusion_cfgs(use_ln=None):
    """(JAX config, port config) of the fusion model with a three-stage
    TriPool spectra encoder; ``use_ln`` the layout the config names (None:
    none named)."""
    from applecider_tpu.config import load_defaults as jax_load_defaults
    from tests.test_torch_pipeline import TINY

    tri = {"channels": [2, 2, 2], "depths": [1, 1, 1], "kernel_sizes_per_stage": [[3, 5, 7]] * 3}
    if use_ln is not None:
        tri["use_ln_stages"] = list(use_ln)
    jcfg, cfg = jax_load_defaults(), load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32"),
                        ("model.AppleCider.spectra_encoder", "tripool"),
                        ("model.SpectraNetTriPool", tri)]:
        jcfg.set(k, v)
        cfg.set(k, v)
    jcfg.set("model.BaselineCLS.dropout", 0.0)
    jcfg.set("model.SpectraNetTriPool.conv_mode", "direct")
    return jcfg, cfg


@pytest.fixture(scope="module")
def tripool_reference():
    """(a reference-named fusion state_dict whose TriPool stages are
    ``TRI_LAYOUT``, a batch, the JAX logits of ``fusion_reference_params``
    on it)."""
    import jax.numpy as jnp

    from applecider_tpu.models.fusion import AppleCiderTask as JaxAppleCiderTask
    from applecider_tpu_torch.models.spectranet import SPECTRUM_BINS

    jcfg, cfg = _tripool_fusion_cfgs(TRI_LAYOUT)
    fusion = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, b in fusion.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.3 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) * 1.5 + 0.5)
    ref = {_fusion_ref_name(n): t.numpy().copy() for n, t in fusion.state_dict().items()}
    assert "spectra_encoder.stage1.0.norm.running_mean" in ref
    assert "spectra_encoder.stage2.0.norm.running_mean" not in ref
    rng = np.random.default_rng(0)
    B, P = 3, 20
    batch = (rng.normal(size=(B, P, 7)).astype(np.float32),
             np.arange(P)[None, :] >= rng.integers(8, P + 1, size=B)[:, None],
             rng.normal(size=(B, 24)).astype(np.float32),
             rng.normal(size=(B, 63, 63, 3)).astype(np.float32),
             rng.normal(size=(B, SPECTRUM_BINS)).astype(np.float32))
    prefix = "img_metadata_encoder.image_tower.backbone."  # the JAX converter's layout
    canonical = {k: v for k, v in ref.items() if not k.startswith(prefix)}
    canonical.update({prefix + k: v for k, v in torch_port.rename_timm_convnext_sd(
        {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}).items()})
    params, stats = jax_port.fusion_reference_params(
        canonical, photometry_layers=1, spectra_depths=(1, 1, 1), astrominn_backbone_depths=(1, 1))
    jtask = JaxAppleCiderTask(jcfg)
    want = np.asarray(jax.jit(lambda v, *b: jtask.module.apply(v, *b, deterministic=True))(
        {"params": params, "batch_stats": stats}, *map(jnp.asarray, batch)))
    return ref, batch, want


@pytest.mark.parametrize("named", ["wrongly", "not"])
def test_reference_fusion_follows_the_checkpoints_tripool_layout(tripool_reference, named):
    """A reference-named fusion checkpoint with mixed BatchNorm/LayerNorm
    TriPool stages imports whether the config names the layout wrongly
    (a warning names both) or not at all; the model built from the layout
    read gives the JAX ``fusion_reference_params`` logits within 1e-5."""
    import warnings

    ref, batch, want = tripool_reference
    _, cfg = _tripool_fusion_cfgs([True] * 3 if named == "wrongly" else None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = importer.import_checkpoint(ref, "AppleCider", cfg)
    said = [str(w.message) for w in caught if "use_ln_stages" in str(w.message)]
    if named == "wrongly":
        assert len(said) == 1 and "[true, true, true]" in said[0] and \
            "[false, true, false]" in said[0], said
    else:
        assert not said
    assert cfg.get_path("model.SpectraNetTriPool.use_ln_stages") == TRI_LAYOUT
    port = build_fusion_model(cfg, device="cpu")
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
