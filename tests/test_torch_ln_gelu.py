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
from applecider_tpu_torch.ops import ln_gelu as lg
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


@pytest.mark.parametrize("shape", [(64, 48), (4, 16, 24), (40, 192), (40, 768), (40, 3072)])
def test_ln_gelu_grads_match_pallas_backward(rng, shape):
    """dx, dscale and dbias of the port's LN+GELU (the plain backward on the
    CPU) == ``jax.grad`` through the Pallas kernels in interpret mode, atol
    1e-5 (the kernel's A&S erf is within 1.5e-7 of the exact one), also at
    SpectraNet's widths 192, 768 and 3072, with rows that the Pallas
    backward tiles (it falls back to the unfused VJP on rows it cannot)."""
    from applecider_tpu.ops.ln_gelu import _pick_rb

    C = shape[-1]
    assert _pick_rb(int(np.prod(shape[:-1])), C) > 0  # the Pallas kernel, not the fallback
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


# (N, C) of the geometry tests: every SpectraNet stage at the train batch,
# ragged row counts with odd and uneven widths up to the widest row a
# group holds (8192 columns in pairs, 4095 one at a time), and wider rows,
# which stream
GEOMETRY_CASES = [(256 * L, C) for C, L in ((192, 3481), (384, 870), (768, 217), (1536, 54), (3072, 13))] + [
    (5, 192), (1, 3072), (1000, 1), (777, 33), (4099, 200), (300, 4096), (100, 5000), (50, 8192),
    (64, 4095), (97 * 3481 + 3, 192), (64, 4097), (37, 10000), (3, 20001)]


@pytest.mark.parametrize("N, C", GEOMETRY_CASES)
def test_bwd_geometry(N, C):
    """K3b's launch geometry, as the wrapper decides it: a function of
    (N, C); a row group's threads hold the whole row in registers
    (32 * warps * chunks * vec >= C) or the row streams (chunks 0, one
    element a thread, a block a group); no more blocks than the rows
    fill, at most one wave of resident blocks; SpectraNet's widths take
    6 elements a thread."""
    geo = lg.bwd_geometry(N, C)
    assert geo == lg.bwd_geometry(N, C)
    assert geo.warps in (1, 2, 4, 8, 16) and geo.groups * 32 * geo.warps == lg.BWD_THREADS
    if geo.chunks:
        assert geo.chunks in lg.BWD_CHUNKS and 32 * geo.warps * geo.chunks * geo.vec >= C
    else:
        assert (geo.vec, geo.warps) == (1, 16) and C > 32 * 16 * lg.BWD_CHUNKS[-1]
    assert 1 <= geo.blocks <= min(-(-N // geo.groups), 2 * lg.BWD_SMS)
    if C % 192 == 0 and C <= 3072:
        assert (geo.vec, geo.chunks, geo.warps) == (2, 3, C // 192)


def test_bwd_geometry_streams_rows_wider_than_a_group_holds():
    assert lg.bwd_geometry(8, 8192).chunks == lg.bwd_geometry(8, 3073).chunks == 8
    assert lg.bwd_geometry(8, 4095, vec=1).chunks == 8
    for C, vec in ((8194, 2), (4097, 2), (4096 + 2, 1)):
        assert lg.bwd_geometry(300, C, vec) == (1, 16, 0, 264)


@pytest.mark.parametrize("N, C, misaligned", [(4099, 200, False), (4099, 200, True),
                                               (37, 10000, False), (64, 6000, True)])
def test_backward_wrapper_launches_its_geometry(monkeypatch, N, C, misaligned):
    """On a device tensor the wrapper launches K3b with ``bwd_geometry``'s
    (vec, warps, chunks, blocks), one vector element where a row is off
    alignment, and sums partial rows of exactly ``blocks`` rows. Checked
    on meta tensors, which have addresses but no data. A row wider than a
    group's registers hold streams (chunks 0), aligned or not."""
    launched = []
    monkeypatch.setattr(lg, "require_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(lg.KERNEL_BWD, "launch", lambda dev, *args: launched.append(args))
    flat = torch.empty(N * C + 1, device="meta")
    x = (flat[1:] if misaligned else flat[:-1]).view(N, C)
    dx, ds, db = lg.ln_gelu_backward(x, torch.empty(C, device="meta"), torch.empty(C, device="meta"),
                                     torch.empty(N, C, device="meta"))
    (x_, scale, bias, g, dx_, ds_part, db_part, n, c, eps, code, vec, warps, chunks, blocks), = launched
    assert (n, c, code) == (N, C, 0) and dx_ is dx and x_ is x
    assert (vec, warps, chunks, blocks) == tuple(lg.bwd_geometry(N, C, 1 if misaligned else 2))
    assert vec == (1 if misaligned or chunks == 0 else 2) and (chunks == 0) == (C > 4096)
    assert ds_part.shape == db_part.shape == (blocks, C)
    assert db_part.data_ptr() - ds_part.data_ptr() == blocks * C * 4
    assert dx.shape == (N, C) and ds.shape == db.shape == (C,)
