"""The port's OverlappedServingFeeder returns the serial router's outputs
(thread and process modes, records carrying raw stamps); its
``assemble_samples`` decodes the stamps to the JAX package's images and
refuses a record without exactly 3 stamps; its process workers pack with
the router's own spectra buckets; ``pipeline_model`` equals JAX's."""

import numpy as np
import pytest
import torch

from applecider_tpu.infer import feeder as jfeed
from applecider_tpu.preprocessing.fitsio import write_fits_image
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.infer import feeder as tfeed
from applecider_tpu_torch.infer.stream import SPEC_POINTS, FusedSpectraStream, RoutedAlertStream
from applecider_tpu_torch.models import build_fusion_model
from tests.test_torch_pipeline import GRID, TINY
from tests.test_torch_preprocessing import assert_bit_equal
from tests.test_torch_serve import count_native_calls


@pytest.fixture(scope="module")
def model():
    cfg = load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32")]:
        cfg.set(k, v)
    return build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))


def _records(rng, n, with_stamps=True):
    records = []
    for _ in range(n):
        P = int(rng.integers(10, 24))
        r = {
            "photo_t": np.sort(rng.uniform(0, 30, P)).astype(np.float32),
            "photo_flux": rng.uniform(1, 100, P).astype(np.float32),
            "photo_err": rng.uniform(0.1, 2, P).astype(np.float32),
            "photo_band": rng.integers(0, 3, P).astype(np.int32),
            "meta19": rng.normal(size=19).astype(np.float32),
        }
        img = rng.normal(size=(63, 63, 3)).astype(np.float32)
        if with_stamps:
            r["stamps"] = [write_fits_image(img[:, :, c]) for c in range(3)]
        else:
            r["image"] = img
        if rng.random() < 0.4:
            r["spec_wl"] = np.sort(rng.uniform(4000, 8500, 60)).astype(np.float32)
            r["spec_flux"] = rng.normal(size=60).astype(np.float32)
        records.append(r)
    return records


def test_assemble_samples_matches_jax(rng, monkeypatch):
    records = _records(rng, 4) + _records(rng, 2, with_stamps=False)
    calls = count_native_calls(monkeypatch, tfeed)
    got = tfeed.assemble_samples(records)
    assert calls == [12]  # the 4 records' stamps in one native call
    want = jfeed.assemble_samples(records)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert "stamps" not in g and list(g) == list(w)
        for k in w:
            assert_bit_equal(np.ascontiguousarray(g[k]), np.ascontiguousarray(w[k]), k)
    assert all("stamps" in r for r in records[:4])  # the input records are left as they were


@pytest.mark.parametrize("n_stamps", [2, 4])
def test_assemble_refuses_a_record_without_three_stamps(rng, n_stamps):
    records = _records(rng, 3)
    records[1]["stamps"] = (records[1]["stamps"] * 2)[:n_stamps]
    with pytest.raises(ValueError, match=f"record 1 has {n_stamps} stamps"):
        tfeed.assemble_samples(records)


def test_assemble_names_the_undecodable_record(rng):
    records = _records(rng, 1, with_stamps=False) + _records(rng, 2)
    records[2]["stamps"][1] = b"not a stamp"
    with pytest.raises(ValueError, match=r"blob 4 \(record 2\)"):
        tfeed.assemble_samples(records)


@pytest.mark.parametrize("mode,routed", [("thread", False), ("process", False), ("process", True)],
                         ids=["thread", "process", "process_routed"])
def test_feeder_matches_serial_router(rng, model, mode, routed, monkeypatch):
    router = (RoutedAlertStream(model, batch_buckets=(8,), wave_grid=GRID, device="cpu") if routed
              else FusedSpectraStream(model, spec_buckets=(0, 2, 4, 8), wave_grid=GRID,
                                      device="cpu"))
    batches = [_records(rng, n) for n in (5, 3, 6, 4)]
    want = [router(tfeed.assemble_samples(rb), length_buckets=(32,)) for rb in batches]
    calls = count_native_calls(monkeypatch, tfeed)  # seen in this process: thread mode
    feeder = tfeed.OverlappedServingFeeder(router, n_workers=2 if mode == "thread" else 1,
                                           depth=2, buffer=2, mode=mode, length_buckets=(32,))
    seen = []
    got = list(feeder.serve(iter(batches), on_result=lambda a: seen.append(a.shape[0])))
    assert seen == [len(b) for b in batches]  # once a batch, in order
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    if mode == "thread":  # one native call a batch, from the worker threads
        assert sorted(calls) == sorted(3 * len(b) for b in batches)


def test_pack_worker_uses_the_routers_spectra_buckets(rng, model):
    router = FusedSpectraStream(model, spec_buckets=(0, 3, 6), wave_grid=GRID, device="cpu")
    records = _records(rng, 8)
    for i, r in enumerate(records):  # 2 spectra: bucket 3 here, 4 in the JAX default tuple
        if i in (1, 5):
            r["spec_wl"] = np.sort(rng.uniform(4000, 8500, 60)).astype(np.float32)
            r["spec_flux"] = rng.normal(size=60).astype(np.float32)
        else:
            r.pop("spec_wl", None)
            r.pop("spec_flux", None)
    packed = tfeed._pack_worker(records, (32,), 63, router.spec_buckets)
    assert packed["spec_wl"].shape == (4, SPEC_POINTS)
    want = router.place(tfeed.assemble_samples(records), length_buckets=(32,), host_only=True)
    assert_bit_equal(packed, want)


def test_pipeline_model_matches_jax():
    for args in ((6000.0, 13400.0, 1), (6000.0, 13400.0, 4), (6000.0, 13400.0, 4, 2000.0),
                 (1500.5, 900.0, 3, None), (100.0, 1e5, 0, 1e4)):
        assert tfeed.pipeline_model(*args) == jfeed.pipeline_model(*args)
