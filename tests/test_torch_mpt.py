"""The port's MPT pretraining == the JAX package's, at small widths in f32
with dropout 0.

The same NumPy-seeded batches and the JAX task's flax weights (carried by
``from_jax_params``) go through both. The mask's random stream is not part
of the contract, so the port's mask is held by its rule, and the loss and
the AdamW step by injecting one mask into both sides (the JAX side through
``applecider_tpu.models.mpt.band_stratified_mask``). Tolerances: heads on
valid tokens <= 1e-4; loss <= 1e-5 relative; parameters after one clipped
AdamW step <= 1e-5; ``apply_event_mask`` and the warm start exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import applecider_tpu.models.mpt as jax_mpt
from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu.train.optim import with_grad_clip
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
from applecider_tpu_torch.models.mpt import (
    MPTTask, apply_event_mask, band_stratified_mask, warmstart_classifier_params,
)
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params

WIDTHS = {"d_model": 16, "n_heads": 2, "n_layers": 2, "dropout": 0.0}


def _cfgs():
    jcfg, cfg = jax_load_defaults(), load_defaults()
    for c in (jcfg, cfg):
        for k, v in WIDTHS.items():
            c.set(f"model.BaselineCLS.{k}", v)
        c.set("train.compute_dtype", "float32")
    return jcfg, cfg


def _batch(seed=0, B=6, L=24, lengths=None):
    """Events with normalised-looking channels, one-hot bands, ragged
    lengths (padding zero), and the (B, L) band ids."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, 7)).astype(np.float32)
    bands = rng.integers(0, 3, size=(B, L))
    x[..., 4:] = 0.0
    x[np.arange(B)[:, None], np.arange(L)[None, :], 4 + bands] = 1.0
    if lengths is None:
        lengths = rng.integers(4, L + 1, size=B)
    pad = np.arange(L)[None, :] >= np.asarray(lengths)[:, None]
    x[pad] = 0.0
    return x, pad, np.where(pad, 0, bands)


@pytest.fixture(scope="module")
def pair():
    """(JAX task, its params, the port's task holding them)."""
    jcfg, cfg = _cfgs()
    jtask = jax_mpt.MPTTask(jcfg)
    x, pad, _ = _batch()
    params = jax.tree.map(np.asarray, jtask.init(jax.random.PRNGKey(0), (x, pad))["params"])
    task = MPTTask(cfg, device="cpu")
    task.module.load_state_dict(from_jax_params(params))
    return jtask, params, task


def _expected_count(bands_row, valid_row, mask_p=0.30):
    n = int(valid_row.sum())
    k = max(int(n * mask_p), 3)
    per_band = [min(int((valid_row & (bands_row == b)).sum()), k // 3) for b in range(3)]
    return per_band, min(k - 3 * (k // 3), n - sum(per_band))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_follows_the_rule(seed):
    """Rows of 0-3 valid tokens, one-band rows and ragged random rows: no
    padding masked; each band's count min(its count, k // 3); the extras
    from the rest, as far as it goes."""
    L = 40
    lengths = [0, 1, 2, 3, 40, 17, 33, 9, 25, 12]
    x, pad, bands = _batch(seed, B=len(lengths), L=L, lengths=lengths)
    bands[4] = 1  # one band only
    bands[5] = 2
    bands = np.where(pad, 0, bands)
    mask = band_stratified_mask(torch.from_numpy(bands), torch.from_numpy(pad), 0.30,
                                torch.Generator().manual_seed(seed)).numpy()
    assert not (mask & pad).any()
    for b in range(len(lengths)):
        valid = ~pad[b]
        per_band, extras = _expected_count(bands[b], valid)
        got = mask[b].sum()
        assert got == sum(per_band) + extras, (b, got, per_band, extras)
        for band in range(3):
            # the band's quota is met, and extras may only add to it
            assert (mask[b] & (bands[b] == band)).sum() >= per_band[band]
    # and the stream is random: another generator picks other tokens
    again = band_stratified_mask(torch.from_numpy(bands), torch.from_numpy(pad), 0.30,
                                 torch.Generator().manual_seed(seed + 100)).numpy()
    assert (again != mask).any()


def test_apply_event_mask_matches_jax():
    x, pad, _ = _batch(3)
    mask = np.random.default_rng(4).random(pad.shape) < 0.3
    want = np.asarray(jax_mpt.apply_event_mask(jnp.asarray(x), jnp.asarray(mask)))
    got = apply_event_mask(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("autograd", [False, True])
def test_heads_match_jax(pair, autograd):
    """Flux, band logits and next-dt heads on the valid tokens <= 1e-4,
    through K2's plain version (no autograd) and K4's at rate 0 (autograd
    in eval mode); the padded tokens' outputs finite."""
    jtask, params, task = pair
    x, pad, _ = _batch(5)
    want = jtask.module.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad),
                              deterministic=True)
    task.module.eval()
    with torch.set_grad_enabled(autograd):
        got = task.module(torch.from_numpy(x), torch.from_numpy(pad))
    valid = ~pad
    for g, w in zip(got, want):
        g = g.detach().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[valid], np.asarray(w)[valid], rtol=0, atol=1e-4)


def _jax_loss_and_grads(jtask, params, batch, mask, monkeypatch):
    monkeypatch.setattr(jax_mpt, "band_stratified_mask", lambda *a: jnp.asarray(mask))
    (loss, aux), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
        params, tuple(jnp.asarray(a) for a in batch), jax.random.PRNGKey(1), True)
    return loss, aux, grads


def test_loss_matches_jax_with_an_injected_mask(pair, monkeypatch):
    """The three masked terms and their weighted sum <= 1e-5 relative, in
    train mode (dropout 0): the attention through K4's plain version, whose
    output at padded queries must stay finite for the masked means."""
    jtask, params, task = pair
    x, pad, bands = _batch(6)
    mask = band_stratified_mask(torch.from_numpy(bands), torch.from_numpy(pad), 0.30,
                                torch.Generator().manual_seed(0))
    _, aux, _ = _jax_loss_and_grads(jtask, params, (x, pad), mask.numpy(), monkeypatch)
    got, got_aux = task.loss((torch.from_numpy(x), torch.from_numpy(pad)), train=True,
                             mask=mask)
    for k in ("loss", "loss_f", "loss_b", "loss_dt"):
        w = float(aux["metrics"][k])
        assert abs(float(got_aux["metrics"][k].detach()) - w) <= 1e-5 * abs(w), k
    z = task.module.trunk(torch.from_numpy(x), torch.from_numpy(pad))
    assert z.requires_grad and torch.isfinite(z).all()
    assert "logits" not in got_aux and torch.isfinite(got)


def test_one_adamw_step_matches_optax(pair, monkeypatch, tmp_path):
    """One clipped AdamW step (pretrain_lr, weight decay 0.01) from the same
    weights and gradients: parameters <= 1e-5."""
    jtask, params, task = pair
    x, pad, bands = _batch(7)
    mask = band_stratified_mask(torch.from_numpy(bands), torch.from_numpy(pad), 0.30,
                                torch.Generator().manual_seed(1))
    _, _, grads = _jax_loss_and_grads(jtask, params, (x, pad), mask.numpy(), monkeypatch)
    tx = with_grad_clip(jtask.make_optimizer(), jtask.grad_clip)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = from_jax_params(jax.tree.map(np.asarray, jax.tree.map(
        lambda p, u: p + u, params, updates)))

    _, cfg = _cfgs()
    fresh = MPTTask(cfg, device="cpu")
    fresh.module.load_state_dict(from_jax_params(params))
    trainer = Trainer(fresh, cfg, tmp_path, device="cpu")
    loss, _ = fresh.loss(trainer.to_device((x, pad)), train=True, mask=mask)
    loss.backward()
    trainer.apply_gradients()
    for name, p in fresh.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_warmstart_copies_the_trunk_and_nothing_else(pair):
    """The port's surgery on the carried state_dicts equals the JAX
    surgery carried over, key for key, and loads into the classifier."""
    jtask, params, _ = pair
    jcfg, cfg = _cfgs()
    x, pad, _ = _batch()
    jcls = JaxBaselineCLSTask(jcfg)
    cls_params = jax.tree.map(np.asarray, jcls.init(
        jax.random.PRNGKey(3), (x, pad, np.zeros(len(x), np.int64)))["params"])
    want = from_jax_params(jax_mpt.warmstart_classifier_params(cls_params, params))
    cls_sd, mpt_sd = from_jax_params(cls_params), from_jax_params(params)
    got = warmstart_classifier_params(cls_sd, mpt_sd)
    assert got.keys() == want.keys() == cls_sd.keys()
    for name, value in got.items():
        assert torch.equal(value, want[name]), name
        source = mpt_sd if name.startswith("trunk.") else cls_sd
        assert torch.equal(value, source[name]), name
    assert any(n.startswith("trunk.") for n in got) and {"fc.weight", "norm.weight"} <= set(got)
    BaselineCLSTask(cfg, device="cpu").module.load_state_dict(got)
