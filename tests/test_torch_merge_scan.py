"""K1's plain PyTorch version == the JAX package's Pallas kernel (interpret
mode) and its XLA scan oracle, exactly, on every kind of row the kernel
must take; and, on time-ascending rows, == the JAX pointer-doubling chain
that the kernel's parallel path follows."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.infer.stream import _band_group_flags
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


def _layout(rng, B, P, kind):
    """(t, band, valid) of one kind of row; the first four keep the serving
    layout (each row time-ascending, +inf in the invalid tail)."""
    t, band, valid = _case(rng, B, P)
    if kind == "one_group":  # every point within dt of the first: one group a band
        t = np.sort(rng.uniform(0, 0.5, (B, P)), axis=1).astype(np.float32)
        t[:, -1] = t[:, 0] + np.float32(0.5)  # exactly dt after the first: still no new group
        valid[:] = True
    elif kind == "singletons":  # every point 0.75 after the one before: a group each
        t = np.broadcast_to(np.arange(P, dtype=np.float32) * 0.75, (B, P)).copy()
        valid[:] = True
    elif kind == "duplicates":  # repeated times and gaps of exactly dt
        t = np.where(valid, np.round(t * 2.0) / 4.0, np.inf).astype(np.float32)
    elif kind == "shuffled":  # not time-ascending
        t = rng.permuted(np.where(valid, t, rng.uniform(0, 30, (B, P))), axis=1)
        t = np.where(valid, t, np.inf).astype(np.float32)
    elif kind == "nan":  # NaN and -inf times, some of them a row's first points
        bad = rng.random((B, P)) < 0.15
        bad[: B // 2, 0] = True
        t = np.where(bad, np.where(rng.random((B, P)) < 0.5, np.nan, -np.inf), t)
        t = t.astype(np.float32)
    elif kind == "holes_inf":  # valid masks with holes, +inf in the holes
        valid = rng.random((B, P)) < 0.6
        t = np.where(valid, t, np.inf).astype(np.float32)
    elif kind == "holes_finite":  # holes holding finite times out of order
        valid = rng.random((B, P)) < 0.6
        t = np.where(valid, t, rng.uniform(0, 30, (B, P))).astype(np.float32)
    return t, band, valid


ASCENDING = ("serving", "one_group", "singletons", "duplicates")
ADVERSARIAL = ("shuffled", "nan", "holes_inf", "holes_finite")


@pytest.mark.parametrize("P", [31, 32, 33, 65])
@pytest.mark.parametrize("kind", ASCENDING[1:] + ADVERSARIAL)
def test_seg_ids_match_pallas_and_scan_on_every_kind_of_row(rng, kind, P):
    t, band, valid = _layout(rng, 7, P, kind)
    got, want, oracle = _both(t, band, valid)
    np.testing.assert_array_equal(got, want)
    # The scan oracle has no open group before a band's first start (-1);
    # the recurrence's starts at position 0. Only NaN and -inf first points
    # of a band show it.
    np.testing.assert_array_equal(got, np.where(oracle == -1, 0, oracle))
    if kind != "nan":
        assert (oracle >= 0).all()


def _chain_seg_ids(t, band, valid, dt=0.5):
    """Seg ids from the JAX pointer-doubling helper, a band at a time: the
    running max of each band's start positions over its points."""
    starts = jax.jit(jax.vmap(functools.partial(_band_group_flags, dt_days=dt)))
    P = t.shape[1]
    seg = np.full(t.shape, P, np.int32)
    for k in range(3):
        is_band = valid & (band == k)
        flags = np.asarray(starts(jnp.asarray(t), jnp.asarray(is_band)))
        latest = np.maximum.accumulate(np.where(flags, np.arange(P), -1), axis=1)
        seg = np.where(is_band, latest, seg)
    return seg


@pytest.mark.parametrize("kind,P", [(k, P) for k in ASCENDING for P in (31, 32, 33, 65)]
                         + [("serving", 257)])
def test_pointer_doubling_chain_gives_the_recurrence(rng, kind, P):
    """On time-ascending rows the chain of successors, expanded by pointer
    doubling (the algorithm of the kernel's parallel path), gives the
    recurrence's group starts."""
    t, band, valid = _layout(rng, 9, P, kind)
    got = seg_ids(torch.from_numpy(t), torch.from_numpy(band), torch.from_numpy(valid), 0.5)
    np.testing.assert_array_equal(got.numpy(), _chain_seg_ids(t, band, valid))
