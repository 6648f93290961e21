"""The single-modality datasets and the alert-sample builder == the JAX
package's, without tolerance:

* ``build_alert_samples`` on a corpus that ``preprocess_data`` built: every
  ``.npy`` sample byte for byte, ``alert_samples.csv`` byte for byte once
  each output root is taken out of its paths, and the returned table equal
  to the JAX DataFrame, with and without ``max_per_object``;
* ``ImageAndMetadataDataset`` sample for sample (images, metadata, one-hot
  targets, fine targets, ids, collated batches) under each crop and norm,
  the cache, and the oversampler's order; the warning for unknown targets;
* ``SpectraDataset`` from ``.npz`` and ``.pt`` tables, sample for sample
  with the edge-crop draws, the label aliases, and the error text;
* ``LogitSequenceDataset``'s padding and ``pad_mask``.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.datasets import image_metadata_dataset as jimg
from applecider_tpu.datasets import logit_sequence_dataset as jlog
from applecider_tpu.datasets import spectra_dataset as jspec
from applecider_tpu.preprocessing.alert_samples import build_alert_samples as jax_build
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.datasets import image_metadata_dataset as timg
from applecider_tpu_torch.datasets import logit_sequence_dataset as tlog
from applecider_tpu_torch.datasets import spectra_dataset as tspec
from applecider_tpu_torch.preprocessing.alert_samples import build_alert_samples
from applecider_tpu_torch.preprocessing.cli import preprocess_data
from applecider_tpu_torch.testing import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A raw corpus of 10 objects preprocessed by the port; its train
    manifest."""
    root = tmp_path_factory.mktemp("single")
    raw, labels = make_corpus(root, n_objects=10, seed=4, n_photometry=12, n_alerts=3)
    preprocess_data(str(raw), str(labels), str(root / "out"), min_per_class=1, seed=42)
    return root, root / "out" / "manifest_train.csv"


def _cfgs(section: str, **settings):
    jcfg, cfg = jax_load_defaults(), load_defaults()
    for c in (jcfg, cfg):
        for k, v in settings.items():
            c.set(f'data_set."{section}".{k}', v)
    return jcfg, cfg


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize("max_per_object", [0, 2])
def test_build_alert_samples_byte_for_byte(corpus, max_per_object):
    root, manifest = corpus
    port_dir, jax_dir = root / f"port{max_per_object}", root / f"jax{max_per_object}"
    got = build_alert_samples(manifest, port_dir, max_per_object=max_per_object, seed=3)
    want = jax_build(manifest, jax_dir, max_per_object=max_per_object, seed=3)
    files = sorted(p.name for p in port_dir.iterdir())
    assert files == sorted(p.name for p in jax_dir.iterdir()) and len(files) == len(want) + 1
    for name in files:
        a, b = (port_dir / name).read_bytes(), (jax_dir / name).read_bytes()
        if name.endswith(".csv"):
            a, b = a.replace(bytes(port_dir), b""), b.replace(bytes(jax_dir), b"")
        assert a == b, name
    assert list(got.columns) == list(want.columns)
    for c in want.columns:
        assert got[c].tolist() == [v.replace(str(jax_dir), str(port_dir)) if c == "filepath" else v
                                   for v in want[c].tolist()], c
    if max_per_object:
        assert want.groupby("obj_id").size().max() <= max_per_object


@pytest.fixture(scope="module")
def samples(corpus):
    """The port's alert samples of the corpus, and one record whose target
    is in neither taxonomy."""
    root, manifest = corpus
    out = root / "samples"
    build_alert_samples(manifest, out)
    rec = np.load(next(out.glob("*.npy")), allow_pickle=True).item()
    rec = {**rec, "obj_id": "ZTFunknown", "target": "Unknown"}
    np.save(out / "ZTFunknown_alert000.npy", np.asarray(rec, dtype=object), allow_pickle=True)
    return out


@pytest.mark.parametrize("settings", [
    {}, {"cutout_size": 32}, {"cutout_size": 41, "image_norm": "median"},
    {"tags": ["vit_tower"], "patch_size": [32, 32], "image_norm": "L2"},
    {"enable_image_cache": True, "image_norm": "median"},
    {"use_oversampling": True, "class_distribution": [0.3, 0.1, 0.1, 0.3, 0.1]},
], ids=["plain", "even_crop", "median", "vit_l2", "cache", "oversampled"])
def test_image_metadata_dataset_matches_jax(samples, settings):
    jcfg, cfg = _cfgs(timg.ImageAndMetadataDataset.SECTION, **settings)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = timg.ImageAndMetadataDataset(cfg, samples)
    assert any("1 records have unrecognized targets" in str(w.message) for w in caught)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jimg.ImageAndMetadataDataset(jcfg, samples)
    assert len(got) == len(want) and list(got.ids()) == list(want.ids())
    if settings.get("use_oversampling"):
        assert len(got) > len(got.records)
        np.testing.assert_array_equal(got.oversampler.index_map, want.oversampler.index_map)
    size = 32 if "tags" in settings else settings.get("cutout_size", 63)
    for _ in range(2 if settings.get("enable_image_cache") else 1):
        for i in range(len(got)):
            s = got.sample(i)
            assert s["image"].shape == (3, size, size)
            _equal(s, want.sample(i))
            _equal(got.get_real_target(i), want.get_real_target(i))
    idx = list(range(min(len(got), 6)))
    _equal(got.collate([got.sample(i) for i in idx]), want.collate([want.sample(i) for i in idx]))
    assert timg.CLASS_GROUPS == jimg.CLASS_GROUPS and timg.REAL_CLASSES == jimg.REAL_CLASSES
    for name in ("SN IIb", "TDE", "Cataclysmic", "SN I", "Unknown"):
        assert timg.coarse_group(name) == jimg.coarse_group(name)


def _spectra_table(path: Path, n: int = 12, length: int = 40, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    names = list(tspec.LABEL_STRINGS) + ["SN IIp", "TDE", "CV"]
    table = {"flux": rng.normal(size=(n, 1, length)).astype(np.float32),
             "labels": [names[i % len(names)] for i in range(n)],
             "redshifts": rng.uniform(0, 0.2, size=n).astype(np.float32),
             "file_paths": [f"s{i}.fits" for i in range(n)]}
    if path.suffix == ".pt":
        torch.save({**table, "flux": [torch.from_numpy(f) for f in table["flux"]],
                    "redshifts": torch.from_numpy(table["redshifts"])}, path)
    else:
        np.savez(path, flux=table["flux"], labels=np.asarray(table["labels"], dtype=object),
                 redshifts=table["redshifts"], file_paths=np.asarray(table["file_paths"], dtype=object))
    return table


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
@pytest.mark.parametrize("augment", [False, True])
def test_spectra_dataset_matches_jax(tmp_path, suffix, augment):
    path = tmp_path / f"table{suffix}"
    _spectra_table(path)
    jcfg, cfg = _cfgs(tspec.SpectraDataset.SECTION, augment=augment)
    for c in (jcfg, cfg):
        c.set("data_loader.seed", 7)
    got, want = tspec.SpectraDataset(cfg, path), jspec.SpectraDataset(jcfg, path)
    assert len(got) == len(want) == 12
    np.testing.assert_array_equal(got.ids(), want.ids())
    cropped = 0
    for epoch in range(2):  # the draws go on across epochs, one stream
        for i in range(len(got)):
            s = got.sample(i)
            _equal(s, want.sample(i))
            cropped += int((s["flux"] == 0).any())
            _equal(got.get_flux(i), want.get_flux(i))
            assert got.get_object_id(i) == want.get_object_id(i)
    assert (cropped > 0) == augment
    batch = [got.sample(i) for i in range(4)]
    _equal(got.collate(batch), jspec.SpectraDataset.collate(batch))


def test_spectra_labels_and_the_error_text():
    for label in list(tspec.LABEL_STRINGS) + ["SN IIp", "TDE", "CV"]:
        assert tspec._label_index(label) == jspec._label_index(label)
    with pytest.raises(ValueError) as got:
        tspec._label_index("SN Iax")
    with pytest.raises(ValueError) as want:
        jspec._label_index("SN Iax")
    assert str(got.value) == str(want.value)
    rng = np.random.default_rng(0)
    flux = rng.normal(size=(2, 1, 50)).astype(np.float32)
    out = tspec.augment_edge_crop(flux, np.random.default_rng(5))
    np.testing.assert_array_equal(out, jspec.augment_edge_crop(flux, np.random.default_rng(5)))


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_logit_sequence_dataset_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(1)
    seqs = [rng.normal(size=(int(n), 3)).astype(np.float32) for n in (2, 10, 13, 1, 7)]
    labels = np.array([0, 3, 1, 4, 2])
    path = tmp_path / f"seq{suffix}"
    if suffix == ".pt":
        torch.save({"sequences": [torch.from_numpy(s) for s in seqs], "labels": labels}, path)
    else:
        obj = np.empty(len(seqs), object)
        obj[:] = seqs
        np.savez(path, sequences=obj, labels=labels)
    jcfg, cfg = jax_load_defaults(), load_defaults()
    got, want = tlog.LogitSequenceDataset(cfg, path), jlog.LogitSequenceDataset(jcfg, path)
    assert len(got) == len(want) == 5
    batch_got = got.collate([got.sample(i) for i in range(5)])
    _equal(batch_got, want.collate([want.sample(i) for i in range(5)]))
    assert batch_got["data"]["sequence"].shape == (5, 10, 3)
    np.testing.assert_array_equal(batch_got["data"]["pad_mask"].sum(1), [8, 0, 0, 9, 3])
