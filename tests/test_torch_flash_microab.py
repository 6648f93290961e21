"""K4x's plain versions (``ops/flash_microab.py``) == the JAX ladder kernels
of ``scripts/tpu_flash_microab.py`` (``_fwd_kernel``, ``_fwd_kernel_batched``)
run through ``pallas_call`` in interpret mode.

``full`` and ``prng_only_no_apply`` draw from the TPU core's PRNG, which has
no CPU lowering, so they are held by their definitions: ``full`` on the
Philox bits fed to ``flash_attention_with_bits(interpret=True)`` (the same
function on injected bits), and ``prng_only_no_apply`` equal to ``no_prng``.

Tolerances: f32 1e-5 abs; bf16 2e-2·max(1, |ref|) (both versions round
the same f32 scores and sums to bf16, and a value between two bf16 steps
may land on either). ``matmul_only`` sums terms of order 1e9 that cancel
where a key is padded, so its f32 rounding error scales with sum_j
|p_j||v_j| (``M``), not with |out|: f32 within 1e-6·max(1, M), bf16 within
2e-2·max(1, |ref|) + 1e-6·M. Without a padded key M is O(L) and that
limit is tight; a case with no padded key checks it there.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from applecider_tpu.ops.flash_attention import _drop_consts, _mask_spec, _qkv_spec
from applecider_tpu.ops.flash_attention import flash_attention_with_bits as jax_flash_bits
from applecider_tpu_torch.ops import flash_attention as fa
from applecider_tpu_torch.ops import flash_microab as fm
from applecider_tpu_torch.tools import flash_microab as tool

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "tpu_flash_microab.py"
RATE, SEED = 0.4, 1234
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _load_script():
    """The script as a private module. Its import points JAX's persistent
    cache elsewhere and prepends to ``sys.path``; both are put back."""
    saved = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("_tpu_flash_microab", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for key, value in saved.items():
            jax.config.update(key, value)
        sys.path[:] = path
    return mod


@pytest.fixture(scope="module")
def script():
    return _load_script()


def _inputs(L, B=4, H=8, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, L, hd)).astype(np.float32) for _ in range(3))
    return q, k, v, rng.random((B, L)) < 0.2


def _jax_ladder(script, mode, q, k, v, pad, dtype, G=2):
    """One rung of the script's kernels, ``pallas_call`` in interpret mode."""
    B, H, L, hd = q.shape
    thresh, drop_scale = _drop_consts(RATE)
    common = dict(scale=1.0 / np.sqrt(hd), thresh=thresh, drop_scale=drop_scale)
    if mode.startswith("batched"):
        kern = functools.partial(script._fwd_kernel_batched, pair_block=fm.pair_block(mode), **common)
    else:
        kern = functools.partial(script._fwd_kernel, mode=mode, **common)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(B // G,),
        in_specs=[_qkv_spec(G, H, L, hd)] * 3 + [_mask_spec(G, L)],
        out_specs=_qkv_spec(G, H, L, hd))
    call = pl.pallas_call(kern, grid_spec=grid_spec, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((B, H, L, hd), dtype))
    out = call(jnp.asarray([7], jnp.int32), *(jnp.asarray(t).astype(dtype) for t in (q, k, v)),
               jnp.asarray(pad.astype(np.int32)[:, None, :]))
    return np.asarray(out.astype(jnp.float32))


def _port(mode, q, k, v, pad, dtype, **kw):
    ts = [torch.from_numpy(t).to(dtype) for t in (q, k, v)]
    return fm.flash_forward_ablation(*ts, torch.from_numpy(pad), mode, RATE, **kw), ts


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("L", [17, 24, 40])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["no_prng", "matmul_only", "batched4", "batched8"])
def test_plain_rung_matches_the_jax_ladder(script, mode, dtypes, L):
    tdt, jdt = dtypes
    q, k, v, pad = _inputs(L)
    want = _jax_ladder(script, mode, q, k, v, pad, jdt)
    got, ts = _port(mode, q, k, v, pad, tdt)
    d = np.abs(got.float().numpy() - want)
    lim = 0.0 if tdt == torch.float32 else 2e-2 * np.maximum(1.0, np.abs(want))
    if mode == "matmul_only":
        mag = fm.matmul_only_magnitude(*ts, torch.from_numpy(pad)).numpy()
        assert np.abs(want).max() > 1e8  # the -1e9 scores reach the output
        lim = lim + 1e-6 * (np.maximum(1.0, mag) if tdt == torch.float32 else mag)
    elif tdt == torch.float32:
        lim = 1e-5
    assert (d <= lim).all(), float(d.max())


@pytest.mark.parametrize("L", [17, 24, 40])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_matmul_only_without_padding_matches_the_jax_ladder(script, dtypes, L):
    """No padded key: no -1e9 in the sums, M = sum_j |p_j||v_j| is O(L),
    so 1e-6·max(1, M) holds the live keys' products tightly."""
    tdt, jdt = dtypes
    q, k, v, pad = _inputs(L)
    pad = np.zeros_like(pad)
    want = _jax_ladder(script, "matmul_only", q, k, v, pad, jdt)
    got, ts = _port("matmul_only", q, k, v, pad, tdt)
    mag = fm.matmul_only_magnitude(*ts, torch.from_numpy(pad)).numpy()
    assert mag.max() < 1e3 and np.abs(want).max() < 1e3
    lim = 1e-6 * np.maximum(1.0, mag)
    if tdt == torch.bfloat16:
        lim = lim + 2e-2 * np.maximum(1.0, np.abs(want))
    d = np.abs(got.float().numpy() - want)
    assert (d <= lim).all(), float(d.max())


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_full_on_injected_bits_matches_pallas_bits(dtypes):
    """``full`` with a seed == the JAX bits kernel fed the same Philox bits."""
    tdt, jdt = dtypes
    q, k, v, pad = _inputs(24, B=2, H=4)
    got, _ = _port("full", q, k, v, pad, tdt, seed=SEED)
    bits = fa.dropout_bits_reference(SEED, 2, 4, 24).numpy()
    args = [jnp.asarray(t).astype(jdt) for t in (q, k, v)]
    want = np.asarray(jax_flash_bits(*args, jnp.asarray(pad.astype(np.int32)[:, None, :]),
                                     jnp.asarray(bits), RATE, True).astype(jnp.float32))
    d = np.abs(got.float().numpy() - want)
    lim = 1e-5 if tdt == torch.float32 else 2e-2 * np.maximum(1.0, np.abs(want))
    assert (d <= lim).all(), float(d.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_full_is_flash_forward_with_seed(dtype):
    q, k, v, pad = _inputs(40)
    got, ts = _port("full", q, k, v, pad, dtype, seed=SEED)
    assert torch.equal(got, fa.flash_forward(*ts, torch.from_numpy(pad), RATE, seed=SEED))


@pytest.mark.parametrize("mode", ["prng_only_no_apply", "batched4", "batched8"])
def test_rung_equals_no_prng(mode):
    q, k, v, pad = _inputs(24)
    got, _ = _port(mode, q, k, v, pad, torch.bfloat16, seed=SEED)
    want, _ = _port("no_prng", q, k, v, pad, torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case, match", [
    ("meta", "CUDA tensors"), ("unknown", "unknown mode"), ("batched4_h6", "does not divide"),
    ("batched8_h4", "does not divide")])
def test_wrapper_refuses(case, match):
    """On every device: a meta tensor, an unknown mode, pair_block not
    dividing H."""
    H = {"batched4_h6": 6, "batched8_h4": 4}.get(case, 8)
    q = torch.zeros((1, H, 3, 16), device="meta" if case == "meta" else "cpu")
    mode = {"meta": "no_prng", "unknown": "no_softmax"}.get(case, case.split("_")[0])
    with pytest.raises(ValueError, match=match):
        fm.flash_forward_ablation(q, q, q, None, mode)


@pytest.mark.parametrize("mode", fm.MODES)
def test_route_names_the_forward_of_each_dtype(mode):
    """bf16 rungs launch the tensor-core forward the training step runs
    (``full`` its Philox instantiation, ``batched{N}`` its N-heads form),
    f32 rungs the FMA one."""
    bf16, f32 = fm.route(mode, torch.bfloat16), fm.route(mode, torch.float32)
    if mode.startswith("batched"):
        assert (bf16, f32) == ("flash_fwd_mma_pairs_kernel", "flash_fwd_pairs_kernel")
    else:
        assert bf16.startswith("flash_fwd_mma_kernel<") and f32.startswith("flash_fwd_kernel<")
        assert bf16.removeprefix("flash_fwd_mma_kernel") == f32.removeprefix("flash_fwd_kernel")
    want = {"full": "<kPhilox>", "no_prng": "<kKeepAll>", "prng_only_no_apply": "<kDrawOnly>",
            "matmul_only": "<kMatmulOnly>"}
    if mode in want:
        assert bf16.endswith(want[mode])


def test_route_refuses_unknown_modes_and_dtypes():
    with pytest.raises(ValueError, match="unknown mode"):
        fm.route("no_softmax", torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fm.route("full", torch.float16)


@pytest.mark.parametrize("L, hd", [(1, 16), (17, 16), (33, 8), (40, 32)])
def test_matmul_only_reads_back_its_rounded_scores(L, hd):
    """chip_smoke's check of the bf16 ``matmul_only`` kernel reads the
    rung's bf16 scores back through the rung with one-hot V; on the plain
    version that read-back is exact (no score flips, no allowance), at
    tile tails and every head width, padded keys included."""
    import chip_smoke

    q, k, v, pad = _inputs(L, B=2, H=4, hd=hd)
    ts = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    pad[:, 0] = False
    D, flips, stray = chip_smoke._matmul_only_flips(*ts, torch.from_numpy(pad))
    assert (flips, stray) == (0, 0) and D.shape == ts[0].shape and not D.any()


def test_plain_batched8_runs_on_the_cpu_at_the_train_length():
    """f32 ``batched8`` at L = 258, whose launch the card refuses (K and V
    of 8 heads over a block's shared memory), is the plain version on CPU
    tensors: ``no_prng``'s output."""
    q, k, v, pad = _inputs(258, B=1)
    got, _ = _port("batched8", q, k, v, pad, torch.float32)
    want, _ = _port("no_prng", q, k, v, pad, torch.float32)
    assert torch.equal(got, want)


def test_loading_the_script_keeps_the_jax_cache_setting():
    before = {key: getattr(jax.config, key) for key in _CACHE_KEYS}
    path = list(sys.path)
    mod = _load_script()
    assert callable(mod._fwd_kernel) and callable(mod._fwd_kernel_batched)
    assert {key: getattr(jax.config, key) for key in _CACHE_KEYS} == before
    assert sys.path == path


def test_tool_split_and_bound():
    """The tool's arithmetic: each stage is the difference of two rungs, and
    the train shape's bound is its bytes (68 MB at 3.35 TB/s)."""
    ms = {"full": 1.0, "prng_only_no_apply": 0.8, "no_prng": 0.7, "matmul_only": 0.4,
          "batched4": 0.6, "batched8": 0.75}
    s = tool.split(ms)
    assert s["products"]["ms"] == 0.4 and s["softmax"]["ms"] == pytest.approx(0.3)
    assert s["draw"]["ms"] == pytest.approx(0.1) and s["apply"]["ms"] == pytest.approx(0.2)
    assert s["pairing_batched4"]["ms"] == pytest.approx(-0.1)
    total = sum(s[n]["share_of_full"] for n in ("products", "softmax", "draw", "apply"))
    assert total == pytest.approx(1.0)
    b, by = tool.bound_ms(tool.TRAIN_SHAPE, torch.bfloat16)
    assert by == "bytes" and b == pytest.approx(0.0202, abs=5e-5)


def test_tool_inputs_and_library_calls():
    """The ladder's inputs are the train shape with a key mask U < 0.2;
    each rung is timed beside the SDPA call computing its function: with
    dropout for ``full``, without for every rung whose output is
    ``no_prng``'s, none for ``matmul_only``."""
    q, k, v, mask = tool.make_inputs(device="cpu")
    assert q.shape == k.shape == v.shape == tool.TRAIN_SHAPE and q.dtype == torch.bfloat16
    assert mask.shape == (256, 258) and 0.19 < float(mask.float().mean()) < 0.21
    assert tool.LIBRARY_RATE["full"] == tool.RATE
    assert {m for m, p in tool.LIBRARY_RATE.items() if p == 0.0} == {
        "no_prng", "prng_only_no_apply", "batched4", "batched8"}
    assert set(fm.MODES) - set(tool.LIBRARY_RATE) == {"matmul_only"}


def test_tool_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.ladder()
    with pytest.raises(ValueError, match="times the card"):
        tool.ladder(device="cpu")
