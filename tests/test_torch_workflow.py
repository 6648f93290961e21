"""The user's workflow up to the training data: the port's ``preprocess_data``
(corpus build, manifests, splits, stats), its split against scikit-learn's,
``FusionDataset``, ``Oversampler`` and the taxonomy, the config overlays and
the registry, each against the JAX package on the same inputs.

Tolerances: none. The CSVs are equal as pandas frames (file paths relative
to each output root; in fact byte for byte), every npz key and every stats
file bit for bit (NaN equal to NaN), splits id for id, dataset samples and
collated batches exactly.
"""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import sklearn.model_selection

from applecider_tpu.config import load_config as jax_load_config
from applecider_tpu.datasets import oversampler as j_over
from applecider_tpu.datasets import taxonomy as j_tax
from applecider_tpu.datasets.fusion_dataset import FusionDataset as JaxFusionDataset
from applecider_tpu.preprocessing.cli import preprocess_data as jax_preprocess
from applecider_tpu.preprocessing.manifest import make_splits_from_manifest as jax_splits
from applecider_tpu.testing import make_corpus
from applecider_tpu_torch import registry
from applecider_tpu_torch.config import load_config
from applecider_tpu_torch.datasets import oversampler as t_over
from applecider_tpu_torch.datasets import taxonomy as t_tax
from applecider_tpu_torch.datasets.fusion_dataset import FusionDataset
from applecider_tpu_torch.preprocessing import manifest as t_manifest
from applecider_tpu_torch.preprocessing.builder import build_all_preprocessed
from applecider_tpu_torch.preprocessing.cli import main as preprocess_main
from applecider_tpu_torch.preprocessing.config import PreprocessConfig

REPO = Path(__file__).resolve().parents[1]
CSVS = ("built_all.csv", "splits.csv", "manifest_train.csv", "manifest_val.csv",
        "manifest_test.csv")
STATS = ("feature_stats_event.npz", "feature_stats_meta.npz", "photo_stats.npz")


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """One raw corpus (15 objects, seed 5, as tests/test_pipeline_end_to_end.py)
    preprocessed by the JAX package and by the port's CLI."""
    root = tmp_path_factory.mktemp("workflow")
    data_dir, labels = make_corpus(root, n_objects=15, seed=5, n_photometry=20, n_alerts=5)
    jax_preprocess(str(data_dir), str(labels), str(root / "jax"), min_per_class=2, seed=42)
    preprocess_main(["--raw_path", str(data_dir), "--spec_path", str(labels),
                     "--output_path", str(root / "port"), "--min_per_class", "2"])
    return root


def _frame(path: Path, root: Path) -> pd.DataFrame:
    df = pd.read_csv(path)
    if "filepath" in df:
        df["filepath"] = [str(Path(p).relative_to(root)) for p in df["filepath"]]
    return df


def _assert_npz_equal(a, b, what):
    assert a.files == b.files, what
    for k in a.files:
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype)
        if x.dtype == object:
            assert list(x.ravel()) == list(y.ravel()), (what, k)
        else:
            np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                          np.atleast_1d(y).view(np.uint8), err_msg=f"{what}:{k}")


@pytest.mark.parametrize("name", CSVS)
def test_manifests_match_jax(prepared, name):
    want = _frame(prepared / "jax" / name, prepared / "jax")
    got = _frame(prepared / "port" / name, prepared / "port")
    assert len(got) == (15 if name in ("built_all.csv", "splits.csv") else len(want))
    pd.testing.assert_frame_equal(got, want)


def test_npz_corpus_matches_jax_bit_for_bit(prepared):
    files = sorted(p.name for p in (prepared / "jax" / "all").glob("*.npz"))
    assert files == sorted(p.name for p in (prepared / "port" / "all").glob("*.npz"))
    assert len(files) == 15
    for name in files:
        with np.load(prepared / "jax" / "all" / name, allow_pickle=True) as a, \
                np.load(prepared / "port" / "all" / name, allow_pickle=True) as b:
            _assert_npz_equal(a, b, name)


@pytest.mark.parametrize("name", STATS)
def test_stats_match_jax_bit_for_bit(prepared, name):
    with np.load(prepared / "jax" / name) as a, np.load(prepared / "port" / name) as b:
        _assert_npz_equal(a, b, name)


def test_parallel_build_matches_serial(tmp_path):
    """A spawn pool of two workers (which import the port alone) builds
    the same corpus as the serial build."""
    data_dir, labels = make_corpus(tmp_path, n_objects=4, seed=9, n_photometry=12, n_alerts=4)
    serial = build_all_preprocessed(PreprocessConfig(data_dir, labels, tmp_path / "serial"))
    pool = build_all_preprocessed(PreprocessConfig(data_dir, labels, tmp_path / "pool",
                                                   num_workers=2))
    assert list(serial["object_id"]) == list(pool["object_id"]) and len(serial) == 4
    for a, b in zip(serial["filepath"], pool["filepath"]):
        with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
            _assert_npz_equal(x, y, a)


# ------------------------------------------------------------------ splits
# (objects, class sizes, seed). Each class size list gives one label per
# object; named cases reach each of make_splits_from_manifest's paths
SPLIT_CASES = [
    (counts, seed)
    for counts in ([5, 5], [7, 7, 7], [3, 3, 3, 3, 3], [10, 4, 9, 2], [20, 13, 8, 30, 7],
                   [2, 2], [40, 1], [6, 6, 6, 6, 6, 6, 6, 6])
    for seed in (0, 42, 7)
]


@pytest.mark.parametrize("counts,seed", SPLIT_CASES)
def test_split_matches_sklearn(tmp_path, counts, seed):
    """The port's ``train_test_split`` gives scikit-learn's (train, test)
    id for id, stratified and not, or raises ``ValueError`` where it does;
    ``make_splits_from_manifest`` then writes the JAX package's splits and
    manifests, through whichever fallback the sizes lead to."""
    names = [f"class{i}" for i in range(len(counts))]
    labels = np.asarray([n for n, c in zip(names, counts) for _ in range(c)], dtype=object)
    rng = np.random.default_rng(seed)
    labels = labels[rng.permutation(len(labels))]
    ids = np.asarray([f"ZTF{i:05d}" for i in range(len(labels))], dtype=object)
    for train_size in (0.7, 0.15 / (1.0 - 0.7)):
        for stratify in (labels, None):
            try:
                want = sklearn.model_selection.train_test_split(
                    ids, train_size=train_size, stratify=stratify, random_state=seed)
            except ValueError:
                with pytest.raises(ValueError):
                    t_manifest.train_test_split(ids, train_size=train_size, stratify=stratify,
                                                random_state=seed)
                continue
            got = t_manifest.train_test_split(ids, train_size=train_size, stratify=stratify,
                                              random_state=seed)
            for g, w in zip(got, want):
                assert list(g) == list(w)

    built = pd.DataFrame({"object_id": ids, "filepath": [f"/none/{i}.npz" for i in ids],
                          "label": [names.index(lab) for lab in labels], "label_str": labels,
                          "n_events": rng.integers(1, 30, len(ids))})
    built.to_csv(tmp_path / "built_all.csv", index=False)
    raised = []
    for out, split in (("jax", jax_splits), ("port", t_manifest.make_splits_from_manifest)):
        try:
            split(tmp_path / "built_all.csv", tmp_path / out, min_per_class=1, seed=seed,
                  strict_stratify=False)
        except ValueError as e:  # too few ids for even the seeded random fallback
            raised.append(str(e))
    assert len(raised) in (0, 2), raised
    if raised:
        return
    for name in CSVS[1:]:
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def test_split_reaches_both_fallbacks():
    """The grid above reaches the stratified split, the first fallback (no
    stratified train split: a class of one member) and the second (a
    stratified train split, then too few ids left to stratify val/test)."""
    def path(counts):
        labels = np.asarray([f"c{i}" for i, c in enumerate(counts) for _ in range(c)])
        ids = np.arange(len(labels))
        try:
            _, rest = sklearn.model_selection.train_test_split(ids, train_size=0.7,
                                                               stratify=labels, random_state=0)
        except ValueError:
            return "first"
        try:
            sklearn.model_selection.train_test_split(rest, train_size=0.15 / (1.0 - 0.7),
                                                     stratify=labels[rest], random_state=0)
        except ValueError:
            return "second"
        return "stratified"

    assert {path(c) for c, _ in SPLIT_CASES} == {"stratified", "first", "second"}


# ------------------------------------------------------------------ dataset
def _configs(prepared, out, **section):
    sec = {"manifest_path": str(prepared / out / "manifest_train.csv"),
           "stats_event_path": str(prepared / out / "photo_stats.npz"), **section}
    overrides = {"data_set": {JaxFusionDataset.SECTION: sec}}
    return jax_load_config(REPO / "configs" / "fusion.toml", overrides), \
        load_config(REPO / "configs" / "fusion.toml", overrides)


@pytest.mark.parametrize("mode,oversample", [("per_object", False), ("per_alert", False),
                                             ("per_object", True)])
def test_fusion_dataset_matches_jax(prepared, mode, oversample):
    jcfg, _ = _configs(prepared, "jax", use_oversampling=oversample)
    _, tcfg = _configs(prepared, "port", use_oversampling=oversample)
    want = JaxFusionDataset(jcfg, mode=mode)
    got = FusionDataset(tcfg, mode=mode)
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.labels, want.labels)
    for i in range(len(want)):
        a, b = got.sample(i), want.sample(i)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{mode}[{i}].{k}")
    batch = list(range(min(len(want), 6)))
    a = got.collate([got.sample(i) for i in batch])["data"]
    b = want.collate([want.sample(i) for i in batch])["data"]
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_oversampler_and_taxonomy_match_jax():
    labels = np.random.default_rng(1).integers(-1, 5, 200)
    labels[labels == 2] = 4  # a class with no samples
    for dist in ([0.3, 0.1, 0.1, 0.3, 0.1], [0.2] * 5):
        a = t_over.Oversampler(dist, labels, seed=3)
        b = j_over.Oversampler(dist, labels, seed=3)
        assert len(a) == len(b)
        np.testing.assert_array_equal(a.index_map, b.index_map)
        np.testing.assert_array_equal(a.additional_per_class, b.additional_per_class)
        np.testing.assert_array_equal(t_over.oversampling_targets(dist, np.bincount(labels[labels >= 0])),
                                      j_over.oversampling_targets(dist, np.bincount(labels[labels >= 0])))
    names = list(j_tax.FINE_10) + ["SN I", "SN IIp", "TDE", "CV", "SN", "unknown"]
    for taxonomy in ("fine10", "coarse5", "coarse4"):
        np.testing.assert_array_equal(t_tax.map_labels(names, taxonomy),
                                      j_tax.map_labels(names, taxonomy))
    np.testing.assert_array_equal(t_tax.downsample_per_class(labels, 20, seed=4),
                                  j_tax.downsample_per_class(labels, 20, seed=4))
    for name in ("FINE_10", "COARSE_5", "COARSE_4", "SPECTRA_9"):
        assert getattr(t_tax, name) == getattr(j_tax, name)


# ------------------------------------------------------------------ config
# keys of the JAX defaults that only the JAX package reads: the JAX fusion
# task's implementation switches, and keys that neither package's code reads
JAX_ONLY_SECTIONS = ()
JAX_ONLY_KEYS = {
    "model.AppleCider.weight_decay",
    # the JAX attention routing, the torch checkpoint import, and the
    # weight decay the JAX classifier does not read either
    *(f"model.BaselineCLS.{k}" for k in (
        "attention_impl", "pretrained_weights_path", "weight_decay")),
    # SpectraNet's reference-config keys that SpectraNetTask does not read
    *(f"model.SpectraNet.{k}" for k in ("flat_dim", "use_ln_stages")),
    # AstroMiNN's: the coord tower takes the nst1 settings, as in the reference
    *(f"model.AstroMiNN.{k}" for k in ("coord_decay", "coord_lr", "fusion_router_dims")),
}
# keys the JAX package takes from its code's defaults and the port from its file
PORT_ONLY_KEYS = {"model.AppleCider.criterion", "model.AppleCider.focal_gamma",
                  "model.AstroMiNN.backbone_depths", "model.AstroMiNN.backbone_dims",
                  "model.AstroMiNN.moe_output_dims"}


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict) and v:
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("config_file", sorted(p.name for p in (REPO / "configs").glob("*.toml")))
def test_load_config_matches_jax(config_file):
    overrides = {"train": {"epochs": 3}, "data_loader": {"batch_size": 7},
                 "data_set": {JaxFusionDataset.SECTION: {"manifest_path": "m.csv"}},
                 "serve": {"horizon_days": 50.0}, "model": {"AppleCider": {"fusion": "concat"}}}
    want = _flat(jax_load_config(REPO / "configs" / config_file, overrides))
    got = _flat(load_config(REPO / "configs" / config_file, overrides))
    only_jax = {k for k in set(want) - set(got) if not k.startswith(JAX_ONLY_SECTIONS)}
    assert only_jax <= JAX_ONLY_KEYS, sorted(only_jax - JAX_ONLY_KEYS)
    assert set(got) - set(want) == PORT_ONLY_KEYS
    assert {k: got[k] for k in set(got) & set(want)} == {k: want[k] for k in set(got) & set(want)}
    assert got["train.epochs"] == 3 and got["model.AppleCider.fusion"] == "concat"
    cfg = load_config(REPO / "configs" / config_file)
    assert cfg.section("serve").get("batch_size") == 1024
    assert cfg.section("no", "such").get("x") is None
    key = f'data_set."{JaxFusionDataset.SECTION}".horizon'
    cfg.set(key, 30.0)
    assert cfg.get_path(key) == 30.0 and cfg.merged_with({"a": {"b": 1}}).get_path("a.b") == 1


def test_registry_resolves_fusion_names_and_refuses_the_rest():
    from applecider_tpu_torch.datasets.image_metadata_dataset import ImageAndMetadataDataset
    from applecider_tpu_torch.datasets.logit_sequence_dataset import LogitSequenceDataset
    from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset
    from applecider_tpu_torch.datasets.spectra_dataset import SpectraDataset
    from applecider_tpu_torch.models.astrominn import AstroMiNNTask
    from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
    from applecider_tpu_torch.models.fusion import build_fusion_model
    from applecider_tpu_torch.models.mpt import MPTTask
    from applecider_tpu_torch.models.spectranet import SpectraNetTask, SpectraNetTriPoolTask

    for name in ("AppleCider", "Fusion", "applecider_tpu.models.fusion.AppleCiderTask",
                 "applecider_tpu_torch.models.fusion.build_fusion_model"):
        assert registry.get_model(name) is build_fusion_model
    for name in ("BaselineCLS", "HyraxBaselineCLS",
                 "applecider_tpu.models.baseline_cls.BaselineCLSTask",
                 "applecider_tpu_torch.models.baseline_cls.BaselineCLSTask"):
        assert registry.get_model(name) is BaselineCLSTask
    for name in ("MPT", "MPTModel", "applecider_tpu.models.mpt.MPTTask",
                 "applecider_tpu_torch.models.mpt.MPTTask"):
        assert registry.get_model(name) is MPTTask
    for name in ("FusionDataset", "CiDErDataset", JaxFusionDataset.SECTION,
                 "applecider_tpu_torch.datasets.fusion_dataset.FusionDataset"):
        assert registry.get_dataset_class(name) is FusionDataset
    for name in ("PhotoEventsDataset", "applecider_tpu.datasets.photo_dataset.PhotoEventsDataset",
                 "applecider_tpu_torch.datasets.photo_dataset.PhotoEventsDataset"):
        assert registry.get_dataset_class(name) is PhotoEventsDataset
    cfg = load_config(REPO / "configs" / "fusion.toml")
    assert registry.builder_from_config(cfg, "infer") is FusionDataset
    cfg = load_config(REPO / "configs" / "photometry.toml")
    assert registry.builder_from_config(cfg, "train") is PhotoEventsDataset
    for name, cls in (("SpectraNet", SpectraNetTask), ("SpectraNetTriPool", SpectraNetTriPoolTask),
                      ("AstroMiNN", AstroMiNNTask)):
        jax_module = "astrominn" if name == "AstroMiNN" else "spectranet"
        for key in (name, f"applecider_tpu.models.{jax_module}.{cls.__name__}",
                    f"{cls.__module__}.{cls.__name__}"):
            assert registry.get_model(key) is cls
    for cls, names in ((SpectraDataset, ("SpectraDataset", "SpectraData")),
                       (ImageAndMetadataDataset, ("ImageAndMetadataDataset",)),
                       (LogitSequenceDataset, ("LogitSequenceDataset",))):
        for key in (*names, cls.SECTION, f"{cls.__module__}.{cls.__name__}"):
            assert registry.get_dataset_class(key) is cls
    assert registry.builder_from_config(load_config(REPO / "configs" / "spectra.toml"),
                                        "train") is SpectraDataset
    assert registry.builder_from_config(load_config(REPO / "configs" / "astrominn.toml"),
                                        "infer") is ImageAndMetadataDataset
    from applecider_tpu_torch.models.zoo import ZOO, ZooTask

    for name in ZOO:
        cls = registry.get_model(name)
        assert issubclass(cls, ZooTask) and cls.__name__ == f"{name}Task"
        for key in (f"applecider_tpu.models.zoo.{name}Task",
                    f"applecider_tpu_torch.models.zoo.{name}Task"):
            assert registry.get_model(key) is cls
    for name in ("applecider_tpu.models.baseline_cls.BaselineCLS", "applecider_tpu.registry.x",
                 "NoSuchModel"):
        with pytest.raises(KeyError):
            registry.get_model(name)
    with pytest.raises(KeyError, match="never imports the JAX package"):
        registry.get_model("applecider_tpu.models.zoo.MetaModel")
    with pytest.raises(KeyError, match="No dataset_class"):
        registry.builder_from_config(load_config(), "train")


@pytest.mark.parametrize("oversample", [False, True])
def test_photo_events_dataset_accessors_match_jax(tmp_path, oversample):
    """The per-field accessors of the JAX data set (``ids``,
    ``get_object_id``, ``get_label``, ``get_photometry``, ``get_mean``,
    ``get_std``) give the JAX values at every index, oversampled indices
    resolved as JAX resolves them; ``sample`` is built from them."""
    from applecider_tpu.config import load_defaults as jax_load_defaults
    from applecider_tpu.datasets.photo_dataset import PhotoEventsDataset as JaxPhotoEventsDataset
    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset
    from tests.test_torch_trainer_options import _write_manifest

    manifest = _write_manifest(tmp_path, "m", 12, 3)
    over = {"data_set": {PhotoEventsDataset.SECTION: {
        "manifest_path": str(manifest), "use_oversampling": oversample, "max_len": 48}}}
    want = JaxPhotoEventsDataset(jax_load_defaults().merged_with(over))
    got = PhotoEventsDataset(load_defaults().merged_with(over))
    assert len(got) == len(want) and (len(got) > 12) == oversample
    assert list(got.ids()) == list(want.ids())
    for i in range(len(want)):
        assert got.get_object_id(i) == want.get_object_id(i)
        assert got.get_label(i) == want.get_label(i)
        np.testing.assert_array_equal(got.get_photometry(i), want.get_photometry(i))
        np.testing.assert_array_equal(got.get_mean(i), want.get_mean(i))
        np.testing.assert_array_equal(got.get_std(i), want.get_std(i))
        g, w = got.sample(i), want.sample(i)
        assert g.keys() == w.keys() and g["label"] == w["label"]
        for k in ("photometry", "mean", "std"):
            np.testing.assert_array_equal(g[k], w[k])
