"""K2's plain PyTorch version == the JAX package's Pallas attention kernel
(interpret mode); the port's attention layers == their flax modules with
the same weights. f32, atol 1e-5 (two frameworks sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.models.layers import MultiHeadSelfAttention as FlaxMHSA
from applecider_tpu.models.layers import TransformerEncoderLayer as FlaxLayer
from applecider_tpu.ops.attention import pallas_masked_attention
from applecider_tpu_torch.models.layers import MultiHeadSelfAttention, TransformerEncoderLayer
from applecider_tpu_torch.ops.attention import masked_attention, masked_attention_reference
from applecider_tpu_torch.utils.weights import from_jax_params


def _qkv(rng, B, H, L, hd):
    return [rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(3)]


def _mask(rng, B, L, masked):
    """Random key-padding lengths, batch row 0 with every key padded (the
    uniform softmax of all-equal -1e9 scores); None when not masked."""
    if not masked:
        return None
    mask = np.arange(L)[None, :] >= rng.integers(1, L + 1, size=B)[:, None]
    mask[0] = True
    return mask


# (L, hd): the tensor-core kernel's 16-row tiles with a tail of 1, of 1 + 16
# and of 1 + 2 * 16 rows; one k16 step half padded (hd 8) and two (hd 32)
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("L,hd", [(1, 16), (17, 8), (33, 16), (24, 32)])
def test_plain_attention_matches_pallas_kernel(rng, masked, L, hd):
    B, H = 2, 4
    q, k, v = _qkv(rng, B, H, L, hd)
    mask = _mask(rng, B, L, masked)
    want = np.asarray(pallas_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), interpret=True))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = masked_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tmask)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ref = masked_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), tmask)
    assert torch.equal(got, ref)  # the CPU wrapper is the plain version


def test_plain_bf16_attention_matches_pallas_bf16(rng):
    """The yardstick of the card's bf16 kernel against the Pallas kernel in
    bf16 at a tile tail (L = 17) with a fully masked row: both keep q.scale
    and the scores in f32 and round P and the output to bf16 once, so they
    agree within a bf16 step, 2e-2 * max(1, |ref|)."""
    B, H, L, hd = 2, 4, 17, 16
    q, k, v = _qkv(rng, B, H, L, hd)
    mask = _mask(rng, B, L, True)
    want = np.asarray(pallas_masked_attention(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(mask),
        interpret=True).astype(jnp.float32))
    got = masked_attention(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
                           torch.from_numpy(mask)).float().numpy()
    assert (np.abs(got - want) <= 2e-2 * np.maximum(1.0, np.abs(want))).all()


def _pad_mask(rng, B, L):
    lengths = rng.integers(1, L + 1, size=B)
    return np.arange(L)[None, :] >= lengths[:, None]


@pytest.mark.parametrize("masked", [True, False])
def test_mhsa_matches_flax(rng, masked):
    B, L, D, H = 3, 21, 32, 4
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _pad_mask(rng, B, L) if masked else None
    flax_m = FlaxMHSA(H, 0.0, dtype=jnp.float32, impl="xla")
    jmask = None if mask is None else jnp.asarray(mask)
    params = flax_m.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask)["params"]
    want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x), jmask))

    m = MultiHeadSelfAttention(D, H, dtype=torch.float32)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.inference_mode():
        got = m(torch.from_numpy(x), tmask).numpy()
        plain = m(torch.from_numpy(x), tmask, kernels=False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, plain)


def test_encoder_layer_matches_flax(rng):
    B, L, D, H = 2, 19, 16, 2
    x = rng.normal(size=(B, L, D)).astype(np.float32)
    mask = _pad_mask(rng, B, L)
    flax_m = FlaxLayer(H, 4 * D, 0.0, dtype=jnp.float32, attn_impl="pallas_interpret")
    params = flax_m.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"]
    want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))

    m = TransformerEncoderLayer(D, H, 4 * D, dtype=torch.float32)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
