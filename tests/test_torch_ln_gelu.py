"""K3's plain PyTorch version (forward) == the JAX package's Pallas LN+GELU
kernel in interpret mode and its unfused reference, at rtol 1e-6 and atol
1e-6 (the bound tests/test_ln_gelu.py holds the kernel to: it covers the
kernel's rational erf against the exact one and one f32 rounding of
outputs up to ~10); the port's SpectraBlock == the flax SpectraBlock with
the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.models.spectranet import SpectraBlock as FlaxSpectraBlock
from applecider_tpu.ops.ln_gelu import ln_gelu as jax_ln_gelu
from applecider_tpu.ops.ln_gelu import ln_gelu_reference as jax_ln_gelu_reference
from applecider_tpu_torch.models.spectranet import SpectraBlock
from applecider_tpu_torch.ops.ln_gelu import ln_gelu, ln_gelu_reference
from applecider_tpu_torch.utils.weights import from_jax_params


@pytest.mark.parametrize("shape", [(64, 48), (4, 16, 24)])
def test_plain_ln_gelu_matches_pallas_and_reference(rng, shape):
    C = shape[-1]
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    pallas = np.asarray(jax_ln_gelu(*args, impl_override="pallas_interpret"))
    reference = np.asarray(jax_ln_gelu_reference(*args))
    targs = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias))
    got = ln_gelu(*targs)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), reference, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ln_gelu_reference(*targs))  # the CPU wrapper is the plain version


def test_plain_ln_gelu_bf16_rounds_once(rng):
    """bf16 input: f32 statistics and GELU, one rounding at the end."""
    x = torch.from_numpy(rng.normal(size=(32, 40)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.ones(40)
    bias = torch.zeros(40)
    got = ln_gelu(x, scale, bias)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ln_gelu(x.float(), scale, bias).to(torch.bfloat16))


@pytest.mark.parametrize("do_pool", [True, False])
def test_spectra_block_matches_flax(rng, do_pool):
    x = rng.normal(size=(2, 64, 3)).astype(np.float32)
    flax_m = FlaxSpectraBlock(out_channels=4, kernel_sizes=(3, 7), do_pool=do_pool,
                              conv_mode="direct", dtype=jnp.float32)
    params = flax_m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(flax_m.apply({"params": params}, jnp.asarray(x)))

    m = SpectraBlock(3, 4, (3, 7), do_pool=do_pool, dtype=torch.float32)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_conv1d_direct_and_max_pool_match_jax(rng):
    """The SpectraNet conv (odd-K 'same' cross-correlation, NLC) and the
    floor-mode max pool == the JAX package's, f32."""
    from applecider_tpu.ops.conv1d import conv1d_direct as jax_conv1d
    from applecider_tpu.ops.conv1d import max_pool1d as jax_max_pool
    from applecider_tpu_torch.ops.conv1d import conv1d_direct, max_pool1d

    x = rng.normal(size=(2, 83, 5)).astype(np.float32)
    w = rng.normal(size=(9, 5, 6)).astype(np.float32)  # flax (K, Cin, Cout)
    b = rng.normal(size=6).astype(np.float32)
    want = np.asarray(jax_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv1d_direct(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(max_pool1d(got, 4).numpy(),
                                  np.asarray(jax_max_pool(jnp.asarray(got.numpy()), 4)))
