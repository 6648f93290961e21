"""The port's host packing == the JAX package's, bit for bit; its device
preprocessing (merge, featurisation, spectrum resampling) == the JAX
functions on the same inputs (merge/featurize rtol 1e-5, atol 1e-6: f32
segment sums may be reordered; resample atol 1e-5); its
``RoutedAlertStream`` == the JAX one with the same weights (atol 1e-5, the
bound of test_torch_pipeline.py), and the ``skip_spectra`` pipeline == the
full one on batches without spectra."""

import dataclasses
import sys
import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.infer import stream as js
from applecider_tpu_torch.infer import stream as ts
from applecider_tpu_torch.ops.merge_scan import seg_ids
from applecider_tpu_torch.testing import make_alert_samples
from tests.test_torch_pipeline import GRID, pair  # noqa: F401  (module fixture)


def _sample(rng, times, with_spec=False, n_spec=80):
    t = np.asarray(times, np.float32)
    n = t.shape[0]
    s = {
        "photo_t": t,
        "photo_flux": rng.uniform(1, 100, n).astype(np.float32),
        "photo_err": rng.uniform(0.1, 2, n).astype(np.float32),
        "photo_band": rng.integers(0, 3, n).astype(np.int32),
        "image": rng.normal(size=(63, 63, 3)).astype(np.float32),
        "meta19": rng.normal(size=19).astype(np.float32),
    }
    if with_spec:
        s["spec_wl"] = np.sort(rng.uniform(4000, 8500, n_spec)).astype(np.float32)
        s["spec_flux"] = rng.normal(size=n_spec).astype(np.float32)
    return s


def _assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k].view(np.uint8), b[k].view(np.uint8), err_msg=k)


def _with_spectrum(s, wl, flux=None):
    wl = np.asarray(wl, np.float32)
    flux = np.cos(np.arange(wl.shape[0]) / 7.0) if flux is None else flux
    return {**s, "spec_wl": wl, "spec_flux": np.asarray(flux, np.float32)}


def _spectra_edges(rng):
    """Spectra at and around the packed width (512), descending, with a NaN
    wavelength (short and overlong), and of one point (no spectrum)."""
    asc = lambda n: np.linspace(3500, 9500, n)  # noqa: E731
    base = lambda: _sample(rng, np.sort(rng.uniform(0, 50, 5)))  # noqa: E731
    nan_short, nan_long = asc(300), asc(1500)
    nan_short[17] = np.nan
    nan_long[900] = np.nan
    nan_long_desc = asc(800)
    nan_long_desc[[100, 400]] = np.nan, 3600.0  # a descent past the NaN
    return [_with_spectrum(base(), asc(512)), _with_spectrum(base(), asc(513)), base(),
            _with_spectrum(base(), asc(2000)), _with_spectrum(base(), asc(700)[::-1]),
            _with_spectrum(base(), asc(90)[::-1]), _with_spectrum(base(), nan_short),
            _with_spectrum(base(), nan_long), _with_spectrum(base(), nan_long_desc),
            _with_spectrum(base(), [5000.0]), _with_spectrum(base(), asc(2))]


SPEC30_BATCHES = {"spec30_63": (26, 63), "spec30_257": (27, 257)}  # name -> (seed, bucket)


def _spec30(case):
    """A 1,024-alert serving batch drawn as ``alerts-spec30`` draws its
    alerts (30% with a spectrum of 80-2,000 points), with light curves of 20
    points up to the case's length bucket, as the feeder batches them; and
    that bucket."""
    seed, bucket = SPEC30_BATCHES[case]
    return make_alert_samples(1024, seed=seed, spectrum_frac=0.3, length_range=(20, bucket),
                              spectrum_points=(80, 2000)), bucket


def _pack_cases(rng):
    asc = [_sample(rng, [1.0, 2.0, 5.0, 9.0]), _sample(rng, [0.5, 3.0]),
           _sample(rng, np.arange(12.0))]
    shuffled = []
    for s in asc:
        perm = rng.permutation(len(s["photo_t"]))
        shuffled.append({**s, **{k: s[k][perm] for k in
                                 ("photo_t", "photo_flux", "photo_err", "photo_band")}})
    long_spec = _sample(rng, [0.0, 1.0])
    long_spec["spec_wl"] = np.linspace(9500, 3500, 2000).astype(np.float32)  # descending
    long_spec["spec_flux"] = np.sin(long_spec["spec_wl"] / 300.0).astype(np.float32)
    long_lc = _sample(rng, np.sort(rng.uniform(0, 300, 300)))
    return {
        "presorted": (asc, {}),
        "shuffled": (shuffled, {}),
        "truncated": (shuffled, {"max_photo": 8}),
        "nan_time": ([_sample(rng, [1.0, np.nan, 2.0]), _sample(rng, [0.0, 4.0])], {}),
        "empty_mid": ([_sample(rng, [1.0, 2.0]), _sample(rng, []), _sample(rng, [0.0, 3.0])], {}),
        "trailing_empty": ([_sample(rng, [1.0, 2.0, 3.0]), _sample(rng, []), _sample(rng, [])],
                           {"max_photo": 16}),
        "empty_batch": ([], {"length_buckets": (8, 16)}),
        "bucketed": (make_alert_samples(5, seed=9, length_range=(20, 180)),
                     {"length_buckets": (64, 192, 257)}),
        "spectra": ([_sample(rng, [1.0, 2.0], True), long_spec, _sample(rng, [3.0])],
                    {"max_photo": 4}),
        "bf16_image": (make_alert_samples(4, seed=11), {"max_photo": 64,
                                                        "image_dtype": jnp.bfloat16}),
        "spectra_edges": (_spectra_edges(rng), {}),
        "spectra_edges_width_300": (_spectra_edges(rng), {"max_spec": 300}),
        "one_point_spectra": ([_with_spectrum(_sample(rng, [1.0]), [4000.0]), _sample(rng, [2.0])],
                              {}),
        "curve_over_257": ([long_lc, *asc], {}),
        "curve_over_257_unsorted": ([{**long_lc, "photo_t": long_lc["photo_t"][::-1].copy()},
                                     *shuffled], {"length_buckets": (63, 257)}),
    }


@pytest.mark.parametrize("case", [*_pack_cases(np.random.default_rng(0)), *SPEC30_BATCHES])
def test_pack_alert_batch_bit_equal_to_jax(rng, case):
    if case in SPEC30_BATCHES:
        samples, bucket = _spec30(case)
        kw = {"length_buckets": (bucket,)}
    else:
        samples, kw = _pack_cases(rng)[case]
    _assert_bit_equal(ts.pack_alert_batch(samples, **kw), js.pack_alert_batch(samples, **kw))


def test_decimate_spectrum_keeps_full_range():
    wl = np.linspace(3500, 9500, 2000).astype(np.float32)
    fx = np.sin(wl / 300.0).astype(np.float32)
    got = ts.decimate_spectrum(wl, fx, 512)
    want = js.decimate_spectrum(wl, fx, 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0] < 3520 and got[0][-1] > 9480


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_decimate_spectrum_sorts_a_copy(dtype):
    wl = np.linspace(9500, 3500, 1300).astype(dtype)
    wl[700] = np.nan
    fx = np.cos(wl / 250.0).astype(dtype)
    wl0, fx0 = wl.copy(), fx.copy()
    got = ts.decimate_spectrum(wl, fx, 512)
    want = js.decimate_spectrum(wl, fx, 512)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w, equal_nan=True)
    assert np.array_equal(wl, wl0, equal_nan=True) and np.array_equal(fx, fx0, equal_nan=True)


SERVING_SPEC_BUCKETS = (0, 4, 8, 16, 32, 64, 96, 112, 128, 192, 256, 320, 384, 512)


def _place_cases(rng):
    """name -> (batch, length_buckets, spec_buckets)."""
    mixed = make_alert_samples(7, seed=5, spectrum_frac=0.5, length_range=(1, 40),
                               spectrum_points=(10, 900))
    cases = _pack_cases(rng)
    small = (0, 2, 4, 8)
    return {
        "mixed": (mixed, (16, 64), small),
        "one": (mixed[:1], (16, 64), small),
        "empty": ([], (16, 64), small),
        "spectra_edges": (_spectra_edges(rng), (16, 64), small),
        "no_spectra": (cases["presorted"][0], (16, 64), small),
        "curve_unsorted": (cases["shuffled"][0], (16, 64), small),
        "curve_over_257": (cases["curve_over_257_unsorted"][0], (63, 257), small),
    }


@pytest.mark.parametrize("case", [*_place_cases(np.random.default_rng(0)), *SPEC30_BATCHES])
@pytest.mark.parametrize("pad_to", [None, 8])
def test_fused_place_host_only_bit_equal_to_jax(rng, pad_to, case):
    if case in SPEC30_BATCHES:
        batch, bucket = _spec30(case)
        length_buckets, spec_buckets = (bucket,), SERVING_SPEC_BUCKETS
    else:
        batch, length_buckets, spec_buckets = _place_cases(rng)[case]
    jf = js.FusedSpectraStream.__new__(js.FusedSpectraStream)  # placement only, no task
    jf.spec_buckets, jf.max_spec = spec_buckets, 512
    tf = ts.FusedSpectraStream.__new__(ts.FusedSpectraStream)
    tf.spec_buckets, tf.max_spec = spec_buckets, 512
    if pad_to is not None:
        pad_to = max(pad_to, len(batch) + 3)
    kw = {"length_buckets": length_buckets, "pad_to": pad_to}
    _assert_bit_equal(tf.place(batch, host_only=True, **kw),
                      js.FusedSpectraStream.place(jf, batch, host_only=True, **kw))


def _counted(pack, samples) -> dict:
    ts.PACK_COUNTS.reset()
    pack(samples)
    return dataclasses.asdict(ts.PACK_COUNTS)


@pytest.mark.parametrize("pack", [
    lambda samples: ts.pack_compact(samples, SERVING_SPEC_BUCKETS),
    lambda samples: ts.pack_alert_batch(samples),
], ids=["pack_compact", "pack_alert_batch"])
def test_pack_counts_follow_the_paths_taken(rng, pack):
    asc = np.linspace(3500, 9500, 600)
    presorted = [_with_spectrum(_sample(rng, [1.0, 2.0, 3.0]), asc),
                 _with_spectrum(_sample(rng, [0.5, 4.0]), asc[:100]), _sample(rng, [2.0])]
    assert _counted(pack, presorted) == {
        "batches": 1, "photo_sorted": 0, "spectra": 2, "spectra_sorted": 0,
        "spectra_decimated": 1, "scatter_sorted": 0}
    assert _counted(pack, []) == {
        "batches": 1, "photo_sorted": 0, "spectra": 0, "spectra_sorted": 0,
        "spectra_decimated": 0, "scatter_sorted": 0}
    nan_short = asc[:100].copy()
    nan_short[5] = np.nan
    unsorted = [_with_spectrum(_sample(rng, [3.0, 1.0, 2.0]), asc[::-1]),
                _with_spectrum(_sample(rng, [1.0]), asc[::-1]),
                _with_spectrum(_sample(rng, [0.0]), nan_short), _sample(rng, [2.0, 5.0])]
    assert _counted(pack, unsorted) == {
        "batches": 1, "photo_sorted": 1, "spectra": 3, "spectra_sorted": 2,
        "spectra_decimated": 2, "scatter_sorted": 1}


def test_pack_counts_lose_no_count_across_threads(rng):
    batch = [_with_spectrum(_sample(rng, [1.0, 2.0]), np.linspace(4000, 8000, 600)),
             _sample(rng, [3.0])]
    n_threads, calls = 16, 25

    def pack():
        for _ in range(calls):
            ts.pack_compact(batch, SERVING_SPEC_BUCKETS)

    ts.PACK_COUNTS.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=pack) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    n = n_threads * calls
    assert (ts.PACK_COUNTS.batches, ts.PACK_COUNTS.spectra, ts.PACK_COUNTS.spectra_decimated) == (
        n, n, n)


def _lc_batch(rng, B, P, t_max=30.0):
    n_valid = rng.integers(0, P + 1, B)
    n_valid[0] = P
    valid = np.arange(P)[None, :] < n_valid[:, None]
    t = np.sort(rng.uniform(0, t_max, (B, P)), axis=1).astype(np.float32)
    t[1] = np.round(t[1] * 4.0) / 4.0  # duplicates and gaps of exactly dt
    t = np.where(valid, t, 0.0).astype(np.float32)
    flux = np.where(valid, rng.uniform(1, 100, (B, P)), 0.0).astype(np.float32)
    err = np.where(valid, rng.uniform(0.1, 2, (B, P)), 1.0).astype(np.float32)
    band = np.where(valid, rng.integers(0, 3, (B, P)), 0).astype(np.int32)
    band[2, :3] = 3  # out-of-range band stays unmerged
    return t, flux, err, band, valid


def _jax_merge(t, flux, err, band, valid):
    return [np.asarray(a) for a in jax.vmap(partial(js.merge_light_curve, assume_sorted=True))(
        jnp.asarray(t), jnp.asarray(flux), jnp.asarray(err), jnp.asarray(band), jnp.asarray(valid))]


def _torch_merge(t, flux, err, band, valid):
    t, flux, err, band, valid = (torch.from_numpy(a) for a in (t, flux, err, band, valid))
    seg = seg_ids(torch.where(valid, t, float("inf")), band, valid, 0.5)
    return ts.merge_light_curve(t, flux, err, band, valid, seg)


def test_merge_light_curve_matches_jax(rng):
    arrays = _lc_batch(rng, 6, 48)
    got = _torch_merge(*arrays)
    want = _jax_merge(*arrays)
    for g, w, name in zip(got, want, ("t", "flux", "err", "band", "valid")):
        if name in ("band", "valid"):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("horizon", [None, 100.0])
def test_featurize_events_matches_jax(rng, horizon):
    merged = _jax_merge(*_lc_batch(rng, 6, 40, t_max=300.0))
    want = jax.vmap(partial(js.featurize_events, horizon=horizon))(*map(jnp.asarray, merged))
    got = ts.featurize_events(*(torch.from_numpy(np.array(a)) for a in merged),
                              horizon=horizon)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-5, atol=1e-6)


def _spectra(rng, R, S, G_grid):
    wl = np.zeros((R, S), np.float32)
    fx = np.zeros((R, S), np.float32)
    vd = np.zeros((R, S), bool)
    for r in range(1, R):  # row 0 stays empty, like the compact block's zero row
        n = int(rng.integers(3, S + 1))
        w = np.sort(rng.uniform(4000, 8500, n)).astype(np.float32)
        if r % 3 == 0 and n > 6:
            w[n // 2] = w[n // 2 - 1]  # duplicate wavelengths
        if r % 4 == 0:
            w[: min(5, n)] = G_grid[[7, 99, 1000, 2480, 3480]][: min(5, n)]  # grid hits
            w = np.sort(w)
        wl[r, :n] = w
        fx[r, :n] = np.sin(w * 0.013) + 0.1 * np.cos(w)
        vd[r, :n] = True
    return wl, fx, vd


@pytest.mark.parametrize("uniform", [True, False])
def test_resample_spectrum_matches_jax(rng, uniform):
    grid = np.linspace(4500, 7980, 3481, dtype=np.float32)
    if not uniform:
        grid = np.sort(rng.uniform(4500, 7980, 257)).astype(np.float32)
    wl, fx, vd = _spectra(rng, 9, 300, np.linspace(4500, 7980, 3481, dtype=np.float32))
    want = np.asarray(jax.vmap(partial(js.resample_spectrum, grid=jnp.asarray(grid),
                                       assume_sorted=True))(wl, fx, vd))
    spectrum_grid = ts.SpectrumGrid(grid, "cpu")
    assert spectrum_grid.uniform == uniform
    got = spectrum_grid.resample(torch.from_numpy(wl), torch.from_numpy(fx), torch.from_numpy(vd))
    np.testing.assert_allclose(got.numpy()[1:], want[1:], rtol=0, atol=1e-5)
    assert torch.isfinite(got).all()


def test_median_exact_even_and_odd(rng):
    for n in (2, 7, 128, 3481):
        x = rng.normal(size=(3, n)).astype(np.float32)
        np.testing.assert_array_equal(ts._median_exact(torch.from_numpy(x)).numpy(),
                                      np.median(x, axis=-1).astype(np.float32))


# ------------------------------------------------ spectrum-presence routing
def _routed_samples(rng, flags):
    samples = make_alert_samples(len(flags), seed=int(rng.integers(1 << 30)), spectrum_frac=0.0,
                                 length_range=(3, 32), spectrum_points=(2, 2))
    for s, f in zip(samples, flags):
        if f:
            n = int(rng.integers(20, 700))  # > 512 points exercises decimation
            s["spec_wl"] = np.sort(rng.uniform(4000, 8500, n)).astype(np.float32)
            s["spec_flux"] = rng.normal(size=n).astype(np.float32)
    return samples


@pytest.fixture(scope="module")
def routers(pair):
    """The JAX and the port ``RoutedAlertStream`` with the same weights, one
    batch bucket (8) and one length bucket (32): one JAX compile a pipeline."""
    task, params, model = pair
    jr = js.RoutedAlertStream(task, batch_buckets=(8,), wave_grid=GRID)
    tr = ts.RoutedAlertStream(model, batch_buckets=(8,), wave_grid=GRID, device="cpu")
    return params, jr, tr


@pytest.mark.parametrize("flags", [(True, False, True, False, False, True, False),
                                   (True,) * 3, (False,) * 5, ()],
                         ids=["mixed", "all_spectra", "no_spectra", "empty"])
def test_routed_stream_matches_jax(rng, routers, flags):
    params, jr, tr = routers
    samples = _routed_samples(rng, flags)
    got = tr(samples, length_buckets=(32,))
    want = np.asarray(jr(params, samples, length_buckets=(32,)))
    assert got.shape == want.shape == (len(flags), 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_routed_stream_pads_to_its_buckets(rng, pair):
    _, _, model = pair
    router = ts.RoutedAlertStream(model, batch_buckets=(2, 4), wave_grid=GRID, device="cpu")
    samples = _routed_samples(rng, (True, False, False, False, True))
    n, parts = router.place(samples, length_buckets=(32,))
    (full, full_idx), (nospec, nospec_idx) = parts
    assert n == 5 and full_idx == [0, 4] and nospec_idx == [1, 2, 3]
    assert full["photo_t"].shape == (2, 32) and full["spec_wl"].shape == (2, 512)
    assert nospec["photo_t"].shape == (4, 32) and nospec["spec_wl"].shape == (4, 1)
    torch.testing.assert_close(nospec["image"][3], nospec["image"][0])  # pad row tiles row 0
    probs = router.run_placed((n, parts))()
    np.testing.assert_allclose(probs, router(samples, length_buckets=(32,)), rtol=0, atol=0)


def test_skip_spectra_equals_full_pipeline(rng, pair):
    """On batches with no spectrum the skip_spectra pipeline (one zero
    SpectraNet row, broadcast) equals the full one (a zero row each)."""
    _, _, model = pair
    samples = _routed_samples(rng, (False,) * 6)
    raw = {k: torch.from_numpy(v) for k, v in
           ts.pack_alert_batch(samples, max_photo=32, max_spec=16).items()}
    full = ts.AlertStreamPipeline(model, wave_grid=GRID, device="cpu")(raw)
    skip = ts.AlertStreamPipeline(model, wave_grid=GRID, device="cpu", skip_spectra=True)(raw)
    np.testing.assert_allclose(skip.numpy(), full.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ts.AlertStreamPipeline(model, device="cpu", skip_spectra=True, compact_spectra=True)
