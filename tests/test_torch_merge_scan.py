"""K1's plain PyTorch version == the JAX package's Pallas kernel (interpret
mode) and its XLA scan oracle, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.ops.merge_scan import seg_ids_pallas, seg_ids_scan_reference
from applecider_tpu_torch.ops.merge_scan import seg_ids, seg_ids_reference


def _case(rng, B, P):
    t = np.sort(rng.uniform(0, 30, (B, P)), axis=1).astype(np.float32)
    n_valid = rng.integers(0, P + 1, B)
    valid = np.arange(P)[None, :] < n_valid[:, None]
    t = np.where(valid, t, np.inf).astype(np.float32)
    band = rng.integers(0, 3, (B, P)).astype(np.int32)
    return t, band, valid


def _both(t, band, valid):
    want = np.asarray(seg_ids_pallas(jnp.asarray(t), jnp.asarray(band), jnp.asarray(valid),
                                     dt_days=0.5, interpret=True))
    oracle = np.asarray(seg_ids_scan_reference(jnp.asarray(t), jnp.asarray(band),
                                               jnp.asarray(valid), 0.5))
    got = seg_ids(torch.from_numpy(t), torch.from_numpy(band), torch.from_numpy(valid), 0.5)
    return got.numpy(), want, oracle


@pytest.mark.parametrize("B,P", [(3, 1), (9, 63), (5, 257)])
def test_seg_ids_match_pallas_and_scan(rng, B, P):
    got, want, oracle = _both(*_case(rng, B, P))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_seg_ids_duplicates_empty_rows_and_exact_gaps(rng):
    t, band, valid = _case(rng, 9, 40)
    t[0, :] = np.inf  # fully invalid row
    valid[0, :] = False
    t[1, 5] = t[1, 4]  # duplicate times
    t[2] = np.where(valid[2], np.round(t[2] * 4.0) / 4.0, np.inf)  # gaps of exactly dt
    got, want, oracle = _both(t, band, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_seg_ids_out_of_range_band(rng):
    t, band, valid = _case(rng, 5, 24)
    band[valid] = rng.integers(-1, 5, int(valid.sum()))  # bands -1, 3, 4 stay unmerged
    got, want, oracle = _both(t, band, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert (got[valid & ((band < 0) | (band > 2))] == 24).all()


def test_wrapper_on_cpu_is_the_plain_version(rng):
    t, band, valid = (torch.from_numpy(a) for a in _case(rng, 4, 17))
    assert torch.equal(seg_ids(t, band, valid), seg_ids_reference(t, band, valid))
