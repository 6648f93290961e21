"""K3's plain PyTorch versions == the JAX package's Pallas LN+GELU kernels
in interpret mode: the forward and its unfused reference at rtol 1e-6 and
atol 1e-6 (the bound tests/test_ln_gelu.py holds the kernel to: it covers
the kernel's rational erf against the exact one and one f32 rounding of
outputs up to ~10), the backward's dx, dscale and dbias at atol 1e-5; the
port's SpectraBlock == the flax SpectraBlock with the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.models.spectranet import SpectraBlock as FlaxSpectraBlock
from applecider_tpu.ops.ln_gelu import ln_gelu as jax_ln_gelu
from applecider_tpu.ops.ln_gelu import ln_gelu_reference as jax_ln_gelu_reference
from applecider_tpu_torch.models.spectranet import SpectraBlock
from applecider_tpu_torch.ops.ln_gelu import ln_gelu, ln_gelu_backward_reference, ln_gelu_reference
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


@pytest.mark.parametrize("shape", [(64, 48), (4, 16, 24)])
def test_ln_gelu_grads_match_pallas_backward(rng, shape):
    """dx, dscale and dbias of the port's LN+GELU (the plain backward on the
    CPU) == ``jax.grad`` through the Pallas kernels in interpret mode, atol
    1e-5 (the kernel's A&S erf is within 1.5e-7 of the exact one)."""
    C = shape[-1]
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bias = rng.normal(size=C).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    def loss(x, s, b):
        return jnp.sum(jax_ln_gelu(x, s, b, impl_override="pallas_interpret") * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ts = [torch.from_numpy(t).requires_grad_() for t in (x, scale, bias)]
    ln_gelu(*ts).backward(torch.from_numpy(g))
    for t, w, name in zip(ts, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0, atol=1e-5, err_msg=name)
    dx, ds, db = ln_gelu_backward_reference(*(torch.from_numpy(t) for t in (x, scale, bias, g)))
    assert torch.equal(dx, ts[0].grad) and torch.equal(ds, ts[1].grad) and torch.equal(db, ts[2].grad)


def test_spectra_block_trains_with_f32_ln_gelu_input(rng, monkeypatch):
    """In bf16 compute the f32 conv bias promotes the conv bank's output, so
    the LN+GELU forward and backward see f32 x and f32 g on the training
    path as on the serving path."""
    from applecider_tpu_torch.models import layers
    from applecider_tpu_torch.ops import ln_gelu as lg

    seen = []
    real_fwd, real_bwd = lg.ln_gelu_forward, lg.ln_gelu_backward
    monkeypatch.setattr(lg, "ln_gelu_forward",
                        lambda x, *a: seen.append(("fwd", x.dtype)) or real_fwd(x, *a))
    monkeypatch.setattr(lg, "ln_gelu_backward",
                        lambda x, s, b, g, e: seen.append(("bwd", x.dtype, g.dtype))
                        or real_bwd(x, s, b, g, e))
    m = SpectraBlock(1, 4, (3, 7), do_pool=True, dtype=torch.bfloat16)
    layers.init_weights(m, torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.normal(size=(2, 64, 1)).astype(np.float32)).to(torch.bfloat16)
    m(x).float().sum().backward()
    assert seen == [("fwd", torch.float32), ("bwd", torch.float32, torch.float32)]
    assert all(p.grad is not None for p in m.parameters())
