"""The port's FastDropout meets the semantics ``tests/test_dropout.py`` pins
on the JAX package's: identity in eval mode, kept values scaled exactly by
256 / (256 - thresh), drop rate within binomial noise of the 8-bit
threshold, the gradient through the same mask, bf16 stays bf16, a rate that
rounds to 1 zeroes, a rate that rounds to 0 is the identity, and masks
differ across seeds and sites."""

import pytest
import torch

from applecider_tpu_torch.ops.dropout import DropoutRNG, FastDropout, attach_dropout_rng


def _apply(rate, x, seed=0, train=True):
    mod = FastDropout(rate).train(train)
    mod.dropout_rng = DropoutRNG(seed)
    return mod(x)


def test_eval_is_identity():
    x = torch.arange(24.0).reshape(4, 6)
    assert torch.equal(_apply(0.4, x, train=False), x)
    assert torch.equal(_apply(0.0, x), x)


def test_kept_values_are_scaled_exactly():
    p = 0.4
    thresh = round(p * 256)
    y = _apply(p, torch.ones(512, 512))
    kept = y[y != 0.0]
    torch.testing.assert_close(kept, torch.full_like(kept, 256.0 / (256 - thresh)), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("p", [0.1, 0.3, 0.4, 0.5])
def test_drop_rate_matches_p(p):
    n = 1 << 20
    frac = float((_apply(p, torch.ones(n), seed=7) == 0.0).float().mean())
    p_q = round(p * 256) / 256.0
    assert abs(frac - p_q) < 6 * (p_q * (1 - p_q) / n) ** 0.5


def test_gradient_is_the_same_mask():
    x = torch.ones(256, 64, requires_grad=True)
    y = _apply(0.4, x, seed=3)
    y.sum().backward()
    torch.testing.assert_close(x.grad, y.detach(), rtol=1e-6, atol=0)


def test_bf16_stays_bf16():
    y = _apply(0.4, torch.ones(64, 64, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
    # the scale is rounded to bf16 first, as jnp.asarray(scale, bf16) is
    assert set(y.unique().tolist()) <= {0.0, float(torch.tensor(256 / 154, dtype=torch.bfloat16))}


def test_full_rate_zeroes():
    x = torch.ones(16)
    assert torch.equal(_apply(1.0, x), torch.zeros(16))
    assert torch.equal(_apply(0.999, x), torch.zeros(16))


def test_tiny_rate_is_identity():
    x = torch.arange(16.0)
    assert torch.equal(_apply(0.001, x), x)


def test_masks_differ_across_seeds_and_sites():
    x = torch.ones(1 << 12)
    assert not torch.equal(_apply(0.4, x, seed=0), _apply(0.4, x, seed=1))
    sites = torch.nn.Sequential(FastDropout(0.5), FastDropout(0.5))
    attach_dropout_rng(sites, DropoutRNG(0))
    a, b = sites[0](x), sites[1](x)
    assert ((a == 0) != (b == 0)).any(), "sites reused the same mask"
    assert all(m.dropout_rng is sites[0].dropout_rng for m in sites)
