"""The port's host packing == the JAX package's, bit for bit; its device
preprocessing (merge, featurisation, spectrum resampling) == the JAX
functions on the same inputs (merge/featurize rtol 1e-5, atol 1e-6: f32
segment sums may be reordered; resample atol 1e-5)."""

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
    }


def test_pack_alert_batch_bit_equal_to_jax(rng):
    for name, (samples, kw) in _pack_cases(rng).items():
        _assert_bit_equal(ts.pack_alert_batch(samples, **kw), js.pack_alert_batch(samples, **kw))


def test_decimate_spectrum_keeps_full_range():
    wl = np.linspace(3500, 9500, 2000).astype(np.float32)
    fx = np.sin(wl / 300.0).astype(np.float32)
    got = ts.decimate_spectrum(wl, fx, 512)
    want = js.decimate_spectrum(wl, fx, 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0][0] < 3520 and got[0][-1] > 9480


@pytest.mark.parametrize("pad_to", [None, 8])
def test_fused_place_host_only_bit_equal_to_jax(rng, pad_to):
    samples = make_alert_samples(7, seed=5, spectrum_frac=0.5, length_range=(1, 40),
                                 spectrum_points=(10, 900))
    jf = js.FusedSpectraStream.__new__(js.FusedSpectraStream)  # placement only, no task
    jf.spec_buckets, jf.max_spec = (0, 2, 4, 8), 512
    tf = ts.FusedSpectraStream.__new__(ts.FusedSpectraStream)
    tf.spec_buckets, tf.max_spec = (0, 2, 4, 8), 512
    for batch in (samples, samples[:1], []):
        kw = {"length_buckets": (16, 64), "pad_to": pad_to}
        _assert_bit_equal(tf.place(batch, host_only=True, **kw),
                          js.FusedSpectraStream.place(jf, batch, host_only=True, **kw))


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
