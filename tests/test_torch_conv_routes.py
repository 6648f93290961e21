"""The port's convolution routes (``applecider_tpu_torch/ops/conv1d.py``)
against the JAX package's (``applecider_tpu/ops/conv1d.py``) on the CPU, f32
unless said otherwise, inputs from a NumPy seed:

* ``_next_fast_len`` equal; ``conv1d_fft`` and ``conv1d_s2d`` (block 32
  and 8) forward within 1e-5 * max(1, |y|) and their gradients (x, the
  kernel, the bias) within 1e-4 * max(1, |g|) of ``jax.grad``;
* the router: ``_fft_wins``, ``_s2d_wins`` and the route ``conv1d`` takes
  equal JAX's CPU decisions over a grid of shapes and batches, with
  ``ACFFT_PENALTY`` and ``ACS2D`` set and unset;
* a small SpectraNet and a small TriPool (L = 870, K = 1021 and 201, where
  JAX's CPU router takes the FFT route) under ``conv_mode`` "auto", "fft"
  and "s2d" on both sides, outputs within 1e-4; the bank's FFT convs share
  one rfft of the input;
* each mode builds from the config keys JAX reads (``model.SpectraNet``,
  ``model.SpectraNetTriPool``, both fusion towers); an unknown mode raises;
* the bf16 direct convolution's input gradient (f32 from the bf16
  operands, rounded to bf16) and a bf16 TriPool block's against ``jax.grad``
  in bf16, within 2e-2 * max(1, |g|); the block's parameter gradients
  (sums of B * L bf16 products) within 2e-2 in norm.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.models import spectranet as jsn
from applecider_tpu.ops import conv1d as J
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.models import build_fusion_model, spectranet as tsn
from applecider_tpu_torch.ops import conv1d as T
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_spectranet import _carry, _perturbed_state

BF16_RULE = 2e-2  # the port's bf16 tolerance, times max(1, |ref|)


def _within(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want) - rel * np.maximum(1.0, np.abs(want))
    assert err.max() <= 0, f"max excess {err.max():.3g}"


def _operands(seed, B, L, cin, cout, K):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, cin)).astype(np.float32)
    k = (rng.normal(size=(K, cin, cout)) / np.sqrt(K * cin)).astype(np.float32)
    b = rng.normal(size=cout).astype(np.float32)
    g = rng.normal(size=(B, L, cout)).astype(np.float32)
    return x, k, b, g


def _weight(k):
    """JAX's (K, Cin, Cout) kernel as the port's (Cout, Cin, K) weight."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(2, 1, 0)))


def test_next_fast_len_matches_jax():
    for n in itertools.chain(range(1, 300), range(300, 20000, 97)):
        assert T._next_fast_len(n) == J._next_fast_len(n), n


ROUTE_FNS = {"fft": (J.conv1d_fft, T.conv1d_fft),
             "s2d": (J.conv1d_s2d, T.conv1d_s2d),
             "s2d8": (lambda x, k, b: J.conv1d_s2d(x, k, b, block=8),
                      lambda x, w, b: T.conv1d_s2d(x, w, b, block=8))}


@pytest.mark.parametrize("route", list(ROUTE_FNS))
@pytest.mark.parametrize("shape", [(2, 100, 3, 4, 31), (2, 70, 1, 5, 61), (3, 33, 2, 3, 7),
                                   (1, 300, 1, 2, 101)], ids=str)
def test_route_forward_and_gradients_match_jax(route, shape):
    jf, tf = ROUTE_FNS[route]
    x, k, b, g = _operands(sum(shape), *shape)

    def jloss(x, k, b):
        return jnp.sum(jf(x, k, b) * g)

    want = np.asarray(jf(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_()
    wt = _weight(k).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = tf(xt, wt, bt)
    assert y.dtype == torch.float32
    _within(y.detach().numpy(), want, 1e-5)
    (y * torch.from_numpy(g)).sum().backward()
    _within(xt.grad.numpy(), jgrads[0], 1e-4)
    _within(wt.grad.numpy().transpose(2, 1, 0), jgrads[1], 1e-4)
    _within(bt.grad.numpy(), jgrads[2], 1e-4)


def test_fft_output_is_f32_for_bf16_input_and_s2d_keeps_the_dtype():
    x, k, b, _ = _operands(0, 2, 64, 2, 3, 21)
    xb = torch.from_numpy(x).bfloat16()
    assert T.conv1d_fft(xb, _weight(k)).dtype == torch.float32
    assert T.conv1d_s2d(xb, _weight(k)).dtype == torch.bfloat16
    assert T.conv1d_direct(xb, _weight(k)).dtype == torch.bfloat16
    want = np.asarray(J.conv1d_fft(jnp.asarray(x, jnp.bfloat16), jnp.asarray(k)))
    assert want.dtype == np.float32
    _within(T.conv1d_fft(xb, _weight(k)).numpy(), want, 1e-5)


# ------------------------------------------------------------------ router
GRID = list(itertools.product((13, 54, 217, 870, 3481), (3, 15, 31, 61, 251, 1021),
                              (1, 2, 64, 144), (8, 32, 256), (1, 4, 32, 512)))


@pytest.mark.parametrize("env", [{}, {"ACFFT_PENALTY": "2.5"}, {"ACS2D": "1"}, {"ACS2D": "0"},
                                 {"ACFFT_PENALTY": "40", "ACS2D": "1"}], ids=str)
def test_router_decisions_match_jax_cpu(monkeypatch, env):
    for key in ("ACFFT_PENALTY", "ACS2D"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    taken = set()
    for L, K, cin, cout, B in GRID:
        fft = T._fft_wins(L, K, cin, cout, batch=B, platform="cpu")
        assert fft == J._fft_wins(L, K, cin, cout, batch=B), (L, K, cin, cout, B)
        s2d = T._s2d_wins(K, cin, platform="cpu")
        assert s2d == J._s2d_wins(K, cin), (K, cin)
        # JAX's conv1d: space-to-depth first, then the cost model
        want = "s2d" if s2d else "fft" if fft else "direct"
        got = T.route(B, L, K, cin, cout, "auto", "cpu")
        assert got == want
        taken.add(got)
    assert "fft" in taken and "direct" in taken
    assert ("s2d" in taken) == (env.get("ACS2D") == "1")


def test_explicit_modes_route_as_named_and_other_devices_raise():
    for mode in ("direct", "fft", "s2d"):
        assert T.route(4, 64, 7, 2, 3, mode, "cpu") == mode
    with pytest.raises(ValueError, match="conv_mode"):
        T.conv1d(torch.zeros(1, 8, 1), torch.zeros(1, 1, 3), mode="winograd")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        T.platform_of(torch.device("meta"))


# ----------------------------------------------------------------- modules
L_AUTO = 870
CHANNELS, BANKS = [8, 16], [[3, 1021], [3, 201]]
TRI_CHANNELS = [8, 8]


def _spectranet_pair(mode):
    jm = jsn.SpectraNetModule(channels=CHANNELS, depths=[1, 1], kernel_sizes_per_stage=BANKS,
                              num_classes=5, head_hidden=16, conv_mode=mode, dtype=jnp.float32)
    port = tsn.SpectraNetModule(CHANNELS, (1, 1), BANKS, num_classes=5, head_hidden=16,
                                dtype=torch.float32, conv_mode=mode)
    return jm, port


def _tripool_pair(mode):
    jm = jsn.SpectraNetTriPoolModule(
        channels=TRI_CHANNELS, depths=(1, 1), kernel_sizes_per_stage=BANKS,
        use_ln_stages=(True, True), num_classes=5, conv_mode=mode, dtype=jnp.float32)
    port = tsn.SpectraNetTriPoolModule(TRI_CHANNELS, (1, 1), BANKS, (True, True), num_classes=5,
                                       length=L_AUTO, dtype=torch.float32, conv_mode=mode)
    return jm, port


@pytest.mark.parametrize("mode", ["auto", "fft", "s2d"])
@pytest.mark.parametrize("model", ["spectranet", "tripool"])
def test_small_models_match_jax_under_each_route(model, mode):
    """``auto`` takes the FFT route for the K = 1021 and K = 201 convs on
    both sides (JAX's CPU router, checked here), with one rfft of the input
    a bank; ``fft`` and ``s2d`` run every bank conv by their route."""
    B = 16
    x = np.random.default_rng(11).normal(size=(B, L_AUTO)).astype(np.float32)
    jm, port = (_spectranet_pair if model == "spectranet" else _tripool_pair)(mode)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(x)), jax.random.PRNGKey(0))
    params, stats, state = _carry(shapes, _perturbed_state(port, 9))
    port.load_state_dict(state)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    ffts = []
    real_rfft = torch.fft.rfft

    def counted(t, *a, **k):
        ffts.append(tuple(t.shape))
        return real_rfft(t, *a, **k)

    torch.fft.rfft = counted
    try:
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x)).numpy()
    finally:
        torch.fft.rfft = real_rfft
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # (L, cin, cout, K) of each stage's long conv
    cin1 = CHANNELS[0] if model == "spectranet" else TRI_CHANNELS[0] * 2 * 3
    cout = CHANNELS if model == "spectranet" else TRI_CHANNELS
    for L, cin, co, k in ((L_AUTO, 1, cout[0], 1021), (L_AUTO // 4, cin1, cout[1], 201)):
        assert jsn._takes_fft_path(B, L, k, cin, co, "auto")
        assert T.takes_fft_path(B, L, k, cin, co, "auto", "cpu")
    # one input rfft a bank, one kernel rfft a conv on the FFT route
    inputs = sum(s[0] == B for s in ffts)
    assert (inputs, len(ffts) - inputs) == {"auto": (2, 2), "fft": (2, 4), "s2d": (0, 0)}[mode]


def _config(mode):
    cfg = load_defaults()
    for key, value in {"model.SpectraNet.channels": [4, 8], "model.SpectraNet.depths": [1, 1],
                       "model.SpectraNet.kernel_sizes_per_stage": [[3, 7], [3, 5]],
                       "model.SpectraNet.conv_mode": mode,
                       "model.SpectraNetTriPool.channels": [2, 2],
                       "model.SpectraNetTriPool.kernel_sizes_per_stage": [[3], [3]],
                       "model.SpectraNetTriPool.conv_mode": mode,
                       "model.BaselineCLS.d_model": 16, "model.BaselineCLS.n_heads": 2,
                       "model.BaselineCLS.n_layers": 1,
                       "model.AstroMiNN.backbone_depths": [1, 1],
                       "model.AstroMiNN.backbone_dims": [8, 16],
                       "train.compute_dtype": "float32"}.items():
        cfg.set(key, value)
    cfg.set('data_set."applecider_tpu.datasets.spectra_dataset.SpectraDataset".n_bins', 64)
    return cfg


def _modes_of(module):
    return {getattr(module, n).conv_mode for n in module.block_names}


@pytest.mark.parametrize("mode", list(T.MODES))
def test_each_mode_builds_from_the_config_keys_jax_reads(mode):
    cfg = _config(mode)
    spectra = tsn.SpectraNetTask(cfg, device="cpu")
    tripool = tsn.SpectraNetTriPoolTask(cfg, device="cpu")
    assert _modes_of(spectra.module) == _modes_of(tripool.module) == {mode}
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64)).astype(np.float32))
    for task in (spectra, tripool):
        assert torch.isfinite(task.predict((x,))).all()
    for encoder in ("standard", "tripool"):
        cfg.set("model.AppleCider.spectra_encoder", encoder)
        assert _modes_of(build_fusion_model(cfg, device="cpu").spectra_encoder) == {mode}


def test_an_unknown_mode_raises():
    cfg = _config("winograd")
    with pytest.raises(ValueError, match="conv_mode"):
        tsn.SpectraNetTask(cfg, device="cpu")
    with pytest.raises(ValueError, match="conv_mode"):
        tsn.SpectraNetTriPoolTask(cfg, device="cpu")
    for encoder in ("standard", "tripool"):
        cfg.set("model.AppleCider.spectra_encoder", encoder)
        with pytest.raises(ValueError, match="conv_mode"):
            build_fusion_model(cfg, device="cpu")


# -------------------------------------------------------- bf16 input grad
@pytest.mark.parametrize("shape", [(2, 217, 24, 8, 61), (2, 870, 6, 4, 251)], ids=str)
def test_bf16_direct_input_gradient_matches_jax(shape):
    x, k, b, g = _operands(5, *shape)

    def jloss(x, k, b):
        return jnp.sum(J.conv1d_direct(x, k, b).astype(jnp.float32) * g)

    xj = jnp.asarray(x, jnp.bfloat16)
    jdx, jdk, jdb = jax.grad(jloss, argnums=(0, 1, 2))(xj, jnp.asarray(k), jnp.asarray(b))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt, bt = _weight(k).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = T.conv1d_direct(xt, wt, bt)
    assert y.dtype == torch.float32  # the bf16 product lifted by the f32 bias, as in JAX
    _within(y.detach().numpy(), np.asarray(J.conv1d_direct(xj, jnp.asarray(k),
                                                           jnp.asarray(b))), BF16_RULE)
    (y * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    _within(xt.grad.float().numpy(), np.asarray(jdx, np.float32), BF16_RULE)
    _within(wt.grad.numpy().transpose(2, 1, 0), jdk, BF16_RULE)
    _within(bt.grad.numpy(), jdb, BF16_RULE)


def test_bf16_tripool_block_gradients_match_jax():
    """A TriPool block (conv bank K = 3, 61, 251 -> LayerNorm -> + the 1x1
    residual -> GELU) in bf16, no pool: its input's gradient element by
    element and every parameter's in norm, against ``jax.grad`` of the flax
    block in bf16."""
    B, L, cin, cout, ks = 2, 300, 12, 4, (3, 61, 251)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, L, cin)).astype(np.float32)
    g = rng.normal(size=(B, L, cout * len(ks))).astype(np.float32)
    jm = jsn.SpectraBlockTriPool(out_channels=cout, kernel_sizes=ks, use_ln=True, do_pool=False,
                                 conv_mode="direct", dtype=jnp.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    shapes = jax.eval_shape(lambda r: jm.init(r, xj), jax.random.PRNGKey(0))
    port = tsn.SpectraBlockTriPool(cin, cout, ks, use_ln=True, do_pool=False,
                                   dtype=torch.bfloat16, conv_mode="direct")
    params, _, state = _carry(shapes, _perturbed_state(port, 12))
    port.load_state_dict(state)

    def jloss(params, x):
        return jnp.sum(jm.apply({"params": params}, x).astype(jnp.float32) * g)

    jparams, jdx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params, xj)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    (port(xt).float() * torch.from_numpy(g)).sum().backward()
    _within(xt.grad.float().numpy(), np.asarray(jdx, np.float32), BF16_RULE)
    # a weight's gradient sums B * L bf16 products: held in norm at the rule
    want = from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams))
    for name, p in port.named_parameters():
        w = want[name].numpy()
        assert np.linalg.norm(p.grad.numpy() - w) <= BF16_RULE * np.linalg.norm(w), name


@pytest.mark.parametrize("mode", ["auto", "fft"])
def test_export_keeps_the_route_in_its_program(mode):
    """A program exported with a symbolic batch holds the route its
    convolutions take at ``route_batch``'s size (auto: stage 1 on the FFT
    route at 16 rows, where the example's 4 rows would take direct) and
    equals the module run on that route at any batch."""
    from applecider_tpu_torch.train.runtime import _export_with_symbolic_batch

    _, module = _spectranet_pair(mode)
    _perturbed_state(module, 4)
    module.eval().requires_grad_(False)
    rng = np.random.default_rng(2)
    xs = {b: torch.from_numpy(rng.normal(size=(b, L_AUTO)).astype(np.float32)) for b in (4, 16)}
    # stage 1's K = 201: direct at the example's 4 rows, FFT at 16
    stage1 = (L_AUTO // 4, 201, CHANNELS[0], CHANNELS[1])
    assert T.route(4, stage1[0], stage1[1], *stage1[2:], mode, "cpu") == \
        {"auto": "direct", "fft": "fft"}[mode]
    assert T.route(16, stage1[0], stage1[1], *stage1[2:], mode, "cpu") == "fft"
    with T.route_batch(16):
        exported, meta = _export_with_symbolic_batch(module, lambda b: (xs[b],), 4, 16)
    assert meta["symbolic_batch"], meta
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    # an input rfft a bank and a kernel rfft a conv on the FFT route
    assert sum(t.startswith("aten.fft_rfft") for t in targets) == {"auto": 4, "fft": 6}[mode]
    program = exported.module()
    fft = tsn.SpectraNetModule(CHANNELS, (1, 1), BANKS, num_classes=5, head_hidden=16,
                               dtype=torch.float32, conv_mode="fft")
    fft.load_state_dict(module.state_dict())
    with torch.no_grad():
        for b, x in xs.items():
            np.testing.assert_allclose(program(x).numpy(), fft.eval()(x).numpy(), rtol=0,
                                       atol=1e-5)
