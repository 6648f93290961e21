"""K4's plain versions == the JAX package's injected-bits Pallas kernels
(``flash_attention_with_bits``, interpret mode), and the port's K4 routing.

Tolerances as ``tests/test_flash_attention.py`` holds the Pallas kernel to
its oracle: forward atol 1e-5, q/k/v gradients atol 2e-4 rtol 1e-4 in f32
(two implementations reorder f32 sums); bf16 against the f32 kernel at
atol/rtol 4e-2 forward and 8e-2 of the largest gradient (bf16's 8-bit
mantissa, squared by the backward's products).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.ops.flash_attention import flash_attention_with_bits as jax_flash_bits
from applecider_tpu_torch.models import layers
from applecider_tpu_torch.ops import flash_attention as fa


def _inputs(rng, B=2, H=4, L=24, hd=16):
    q, k, v, tgt = (rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(4))
    pad = np.arange(L)[None, :] >= rng.integers(L // 2, L + 1, size=B)[:, None]
    bits = rng.integers(0, 256, size=(B, H, L, L), dtype=np.uint8)
    return q, k, v, pad, bits, tgt


def _jax(q, k, v, pad, bits, rate, tgt=None, dtype=jnp.float32):
    """JAX forward, and the gradients of sum((out - tgt)^2) when tgt is given."""
    B, _, L, _ = q.shape
    mask_i32 = jnp.asarray(pad.astype(np.int32).reshape(B, 1, L))
    bits = jnp.asarray(bits)
    args = tuple(jnp.asarray(t).astype(dtype) for t in (q, k, v))

    def fwd(q, k, v):
        return jax_flash_bits(q, k, v, mask_i32, bits, rate, True)

    out = np.asarray(fwd(*args).astype(jnp.float32))
    if tgt is None:
        return out
    loss = lambda *a: jnp.sum((fwd(*a).astype(jnp.float32) - tgt) ** 2)  # noqa: E731
    return out, [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


def _port(q, k, v, pad, bits, rate, tgt=None, dtype=torch.float32):
    ts = [torch.from_numpy(t).to(dtype).requires_grad_(tgt is not None) for t in (q, k, v)]
    out = fa.flash_attention_with_bits(*ts, torch.from_numpy(pad), torch.from_numpy(bits), rate)
    if tgt is None:
        return out.float().detach().numpy()
    torch.sum((out.float() - torch.from_numpy(tgt)) ** 2).backward()
    return out.float().detach().numpy(), [t.grad.float().numpy() for t in ts]


# (L, hd): the tensor-core kernels' 16-row tiles with a tail of 1 and of
# 1 + 16 rows, one k16 step padded (hd 8) and two (hd 32)
TILE_CASES = [(16, 8), (17, 16), (33, 16), (24, 32)]


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("L,hd", TILE_CASES)
def test_plain_forward_matches_pallas_bits(rng, rate, L, hd):
    q, k, v, pad, bits, _ = _inputs(rng, B=2, H=2, L=L, hd=hd)
    np.testing.assert_allclose(_port(q, k, v, pad, bits, rate), _jax(q, k, v, pad, bits, rate),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("L,hd", TILE_CASES)
def test_plain_gradients_match_pallas_bits(rng, rate, L, hd):
    q, k, v, pad, bits, tgt = _inputs(rng, B=2, H=2, L=L, hd=hd)
    _, want = _jax(q, k, v, pad, bits, rate, tgt)
    _, got = _port(q, k, v, pad, bits, rate, tgt)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=1e-4, err_msg=f"d{name}")


def test_plain_bf16_gradients_match_pallas_bits_bf16(rng):
    """The yardstick of the card's bf16 backward against the Pallas kernel
    in bf16 at a tile tail (L = 17): both round P, pd, dO and ds to bf16
    before their products, so the gradients agree within a bf16 step or
    two, 2e-2 * max(1, |g|)."""
    q, k, v, pad, bits, tgt = _inputs(rng, B=2, H=2, L=17, hd=16)
    _, want = _jax(q, k, v, pad, bits, 0.25, tgt, dtype=jnp.bfloat16)
    _, got = _port(q, k, v, pad, bits, 0.25, tgt, dtype=torch.bfloat16)
    for a, b, name in zip(got, want, "qkv"):
        assert (np.abs(a - b) <= 2e-2 * np.maximum(1.0, np.abs(b))).all(), f"d{name}"


def test_plain_bf16_matches_f32_kernel(rng):
    q, k, v, pad, bits, tgt = _inputs(rng, B=2, H=2, L=16, hd=8)
    out32, g32 = _jax(q, k, v, pad, bits, 0.25, tgt)
    out, grads = _port(q, k, v, pad, bits, 0.25, tgt, dtype=torch.bfloat16)
    np.testing.assert_allclose(out, out32, atol=4e-2, rtol=4e-2)
    for a, b, name in zip(grads, g32, "qkv"):
        assert np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-6) < 8e-2, f"d{name}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prng_function_is_its_plain_twin_on_cpu(rng, dtype):
    """On CPU tensors the autograd function runs the plain forward and
    backward on the Philox twin's bits, exactly."""
    q, k, v, pad, _, tgt = _inputs(rng, B=2, H=2, L=20, hd=16)
    rate, seed = 0.4, 1234
    ts = [torch.from_numpy(t).to(dtype).requires_grad_() for t in (q, k, v)]
    mask = torch.from_numpy(pad)
    out = fa.flash_attention(*ts, mask, seed, rate)
    dout = torch.from_numpy(tgt).to(dtype)
    out.backward(dout)
    keep = fa.dropout_bits_reference(seed, 2, 2, 20) >= 102
    plain = [t.detach() for t in ts]
    assert torch.equal(out, fa.flash_attention_reference(*plain, mask, keep, rate))
    for got, want in zip((t.grad for t in ts),
                         fa.flash_attention_backward_reference(*plain, mask, keep, rate, dout)):
        assert got.dtype == dtype and torch.equal(got, want)
    out2, keep_u8 = fa.flash_attention_export_mask(*plain, mask, seed, rate)
    assert torch.equal(out2, out.detach()) and torch.equal(keep_u8, keep.to(torch.uint8))
    # the replay contract: keep * 255 through the bits path reproduces the draw
    replay = fa.flash_attention_with_bits(*plain, mask, keep_u8 * 255, rate)
    assert torch.equal(replay, out.detach())


def test_dropout_bits_reference_is_philox():
    """Seed 0, elements 0..3 are the low bytes of Philox4x32-10 at counter 0
    and key 0: Random123's known answer (6627e8d5 e169c58d bc57ac4c
    9b00dbd8)."""
    assert fa.dropout_bits_reference(0, 1, 1, 2).flatten().tolist() == [0xD5, 0x8D, 0x4C, 0xD8]


def test_dropout_bits_reference_seeds_and_rate():
    a = fa.dropout_bits_reference(7, 2, 4, 64)
    assert a.shape == (2, 4, 64, 64) and a.dtype == torch.uint8
    assert torch.equal(a, fa.dropout_bits_reference(7, 2, 4, 64))
    assert (a != fa.dropout_bits_reference(8, 2, 4, 64)).float().mean() > 0.99
    n = a.numel()
    for rate in (0.1, 0.4):
        thresh, _ = fa._drop_consts(rate)
        p_keep = (256 - thresh) / 256
        frac = float((a >= thresh).float().mean())
        assert abs(frac - p_keep) < 6 * (p_keep * (1 - p_keep) / n) ** 0.5


def test_drop_consts():
    assert fa._drop_consts(0.4) == (102, 256.0 / 154)
    assert fa._drop_consts(0.001) == (0, 1.0)
    with pytest.raises(ValueError):
        fa._drop_consts(0.999)


def test_attention_routes_by_autograd_and_mode(rng, monkeypatch):
    """Under autograd the layer reaches K4, with its dropout in train mode
    and rate 0 in eval mode; without autograd it reaches K2, which has no
    backward."""
    calls = []
    real_flash, real_k2 = layers.flash_attention, layers.masked_attention
    monkeypatch.setattr(layers, "flash_attention",
                        lambda *a, **kw: calls.append(("k4", a[5])) or real_flash(*a, **kw))
    monkeypatch.setattr(layers, "masked_attention",
                        lambda *a, **kw: calls.append(("k2", None)) or real_k2(*a, **kw))
    m = layers.MultiHeadSelfAttention(16, 2, dropout=0.4, dtype=torch.float32)
    layers.init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(2, 10, 16)).astype(np.float32))
    mask = torch.zeros(2, 10, dtype=torch.bool)
    m.eval()
    with torch.no_grad():
        want = m(x, mask)
    got = m(x, mask)  # parameters require grad: autograd records
    got.sum().backward()
    m.train()
    m(x, mask).sum().backward()
    assert calls == [("k2", None), ("k4", 0.0), ("k4", 0.4)]
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=1e-6)
