"""Raw-alert serving: the port's per-alert samples from object directories
== the JAX package's, bit for bit; its ``serve_alert_stream`` (binned and
arrival-order) == the JAX ``serve_alert_stream`` with the JAX weights
carried over, to atol 1e-5 (rtol 0), the bound of test_torch_pipeline.py;
the JSONL rows the same; a corrupt object skipped with a warning."""

import json
import shutil
import warnings

import numpy as np
import pytest

from applecider_tpu.infer import serve as js
from applecider_tpu.testing import make_corpus
from applecider_tpu_torch.infer import serve as ts
from tests.test_torch_pipeline import GRID, pair  # noqa: F401  (module fixture)
from tests.test_torch_preprocessing import assert_bit_equal

BATCH = 4
BUCKETS = (64,)  # one length bucket: the JAX side compiles one shape a spectra bucket


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir, _ = make_corpus(tmp_path_factory.mktemp("serve"), n_objects=5, seed=7,
                              n_photometry=24, n_alerts=5)
    return data_dir


@pytest.fixture(scope="module")
def jax_served(pair, corpus, tmp_path_factory):
    """The JAX ``serve_alert_stream`` over the corpus (binned), its JSONL."""
    task, params, _ = pair
    out = tmp_path_factory.mktemp("jsonl") / "jax.jsonl"
    pairs = list(js.iter_alert_samples(corpus))
    summary = js.serve_alert_stream(task, params, iter(pairs), batch_size=BATCH,
                                    length_buckets=BUCKETS, wave_grid=GRID, out_jsonl=out)
    return pairs, summary, [json.loads(line) for line in out.read_text().splitlines()]


def count_native_calls(monkeypatch, module) -> list:
    """Record the number of stamps of each ``decode_stamps_batch`` call that
    ``module`` makes (the native decoder, run as it is)."""
    calls = []
    inner = module.decode_stamps_batch

    def counted(stamps, hw=63, n_threads=0):
        calls.append(len(stamps))
        return inner(stamps, hw, n_threads)

    monkeypatch.setattr(module, "decode_stamps_batch", counted)
    return calls


@pytest.mark.parametrize("causal", [True, False])
def test_alert_samples_match_jax(corpus, causal, monkeypatch):
    objects = sorted(p.name for p in corpus.iterdir())
    calls = count_native_calls(monkeypatch, ts)
    n = 0
    for obj in objects:
        got = list(ts.alert_samples_for_object(obj, corpus, causal_spectrum=causal))
        want = list(js.alert_samples_for_object(obj, corpus, causal_spectrum=causal))
        assert len(got) == len(want), obj
        for (gi, gs), (wi, ws) in zip(got, want):
            assert_bit_equal(gi, wi, obj)
            assert_bit_equal(gs, ws, obj)
        n += len(got)
    assert n >= 10
    assert len(calls) == len(objects) and sum(calls) >= 3 * n  # one call an object, 3n stamps


def test_odd_stamps_take_the_jax_ladder(corpus, tmp_path, monkeypatch):
    """Short, missing and undecodable cutouts: the alert is padded, or
    dropped, exactly as the JAX reader does."""
    data_dir = tmp_path / "raw"
    shutil.copytree(corpus / "ZTFSYN0002", data_dir / "ZTFSYN0002")
    path = data_dir / "ZTFSYN0002" / "alerts.npy"
    alerts = list(np.load(path, allow_pickle=True))
    from applecider_tpu.preprocessing.fitsio import write_fits_image

    alerts[0]["cutoutScience"]["stampData"] = write_fits_image(np.ones((60, 63), np.float32))
    alerts[1]["cutoutTemplate"] = {}
    alerts[2]["cutoutDifference"]["stampData"] = b"not a stamp"
    alerts[3]["cutoutScience"]["stampData"] = np.arange(63 * 63, dtype=np.float64).reshape(63, 63)
    np.save(path, np.asarray(alerts, dtype=object), allow_pickle=True)
    calls = count_native_calls(monkeypatch, ts)
    got = list(ts.alert_samples_for_object("ZTFSYN0002", data_dir))
    want = list(js.alert_samples_for_object("ZTFSYN0002", data_dir))
    assert calls == [3 * len(alerts)]  # the odd alerts then take the per-stamp ladder
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        assert_bit_equal(gi, wi)
        assert_bit_equal(gs, ws)


@pytest.mark.parametrize("binned", [True, False])
def test_serve_alert_stream_matches_jax(pair, jax_served, tmp_path, binned):
    _, _, model = pair
    pairs, want, want_rows = jax_served
    out = tmp_path / "port.jsonl"
    got = ts.serve_alert_stream(model, iter(pairs), batch_size=BATCH, length_buckets=BUCKETS,
                                binned=binned, wave_grid=GRID, out_jsonl=out, device="cpu")
    assert got["n_alerts"] == want["n_alerts"] == len(pairs)
    g = np.stack([r["probs"] for r in got["results"]])
    w = np.stack([r["probs"] for r in want["results"]])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == len(want_rows)
    for r, wr in zip(rows, want_rows):
        assert list(r) == list(wr)
        assert {k: v for k, v in r.items() if k != "probs"} == \
            {k: v for k, v in wr.items() if k != "probs"}
        np.testing.assert_allclose(r["probs"], wr["probs"], rtol=0, atol=1e-5)


def test_corrupt_objects_skipped_with_a_warning(corpus, tmp_path):
    """A corrupt ``alerts.npy`` and a non-numeric magnitude each skip their
    object with a warning, as the JAX reader skips them."""
    bad_dir = tmp_path / "raw"
    shutil.copytree(corpus, bad_dir)
    (bad_dir / "ZTFSYN0001" / "alerts.npy").write_bytes(b"not a pickle")
    csv = bad_dir / "ZTFSYN0003" / "photometry.csv"
    lines = csv.read_text().splitlines()
    lines[2] = ",".join([lines[2].split(",")[0], "bright"] + lines[2].split(",")[2:])
    csv.write_text("\n".join(lines) + "\n")
    for reader in (ts, js):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pairs = list(reader.iter_alert_samples(bad_dir))
        messages = " ".join(str(w.message) for w in caught)
        assert "ZTFSYN0001" in messages and "ZTFSYN0003" in messages
        assert pairs and not {"ZTFSYN0001", "ZTFSYN0003"} & {i["object_id"] for i, _ in pairs}
        if reader is ts:
            got = [i for i, _ in pairs]
    assert_bit_equal(dict(enumerate(got)), dict(enumerate(i for i, _ in pairs)))
