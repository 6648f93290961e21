"""The whole slice: the port's AppleCider forward and its serving path
(AlertStreamPipeline, FusedSpectraStream, LengthBinnedFeeder, on the CPU)
== the JAX package's on the same alerts with the JAX weights carried over.

Small widths (``_fusion_task(tiny=True)`` in f32 with direct convs, since
the JAX CPU router sends wide f32 convs through its FFT path). Probabilities
agree to atol 1e-5: two frameworks reorder f32 sums, so this is looser than
the 2e-6 between two JAX pipelines and inside the 1e-4 logits bound of
tests/test_full_fusion_parity.py.
"""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _fusion_batch, _fusion_task
from applecider_tpu.infer import stream as js
from applecider_tpu.models.fusion import AppleCiderTask
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.infer import stream as ts
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.testing import make_alert_samples
from applecider_tpu_torch.utils.weights import _KERNEL_AXES, from_jax_params

GRID = np.linspace(4500.0, 7980.0, 128).astype(np.float32)
TINY = [
    ("model.BaselineCLS.d_model", 16), ("model.BaselineCLS.n_heads", 2),
    ("model.BaselineCLS.n_layers", 1), ("model.SpectraNet.channels", [4, 8]),
    ("model.SpectraNet.depths", [1, 1]),
    ("model.SpectraNet.kernel_sizes_per_stage", [[3, 7], [3, 5]]),
    ("model.AstroMiNN.backbone_depths", [1, 1]), ("model.AstroMiNN.backbone_dims", [8, 16]),
]


def _flax_params(shapes: Mapping, state: dict, prefix=()) -> dict:
    """The port's ``state`` laid out as the flax ``shapes`` tree: the
    inverse of ``from_jax_params``."""
    out = {}
    for key, leaf in shapes.items():
        if isinstance(leaf, Mapping):
            out[key] = _flax_params(leaf, state, (*prefix, key))
            continue
        arr = state[".".join((*prefix, "weight" if key in ("kernel", "scale") else key))].numpy()
        if key == "kernel":
            arr = arr.transpose(np.argsort(_KERNEL_AXES[arr.ndim]))
        assert arr.shape == leaf.shape, (prefix, key)
        out[key] = arr
    return out


@pytest.fixture(scope="module")
def pair():
    """(JAX task, its params, the port's model with those weights), f32,
    small widths, direct convs. The weights are drawn by the port and laid
    out as flax params (``jax.eval_shape`` gives the tree without running
    the flax init), then carried back with ``from_jax_params``."""
    cfg = _fusion_task(tiny=True, compute_dtype="float32").config
    cfg.set("model.SpectraNet.conv_mode", "direct")
    task = AppleCiderTask(cfg)
    shapes = jax.eval_shape(lambda k: task.init(k, _fusion_batch(2, tiny=True)),
                            jax.random.PRNGKey(0))["params"]
    tcfg = load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32")]:
        tcfg.set(k, v)
    drawn = build_fusion_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    params = _flax_params(shapes, drawn.state_dict())
    model = build_fusion_model(tcfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return task, params, model


@pytest.mark.parametrize("fusion", ["avg", "concat"])
def test_fusion_logits_match_flax(pair, rng, fusion):
    task, params, model = pair
    B = 3
    x = rng.normal(size=(B, 20, 7)).astype(np.float32)
    pad = np.arange(20)[None, :] >= rng.integers(8, 21, size=B)[:, None]
    meta = rng.normal(size=(B, 24)).astype(np.float32)
    img = rng.normal(size=(B, 63, 63, 3)).astype(np.float32)
    spec = rng.normal(size=(B, 128)).astype(np.float32)
    module = task.module.clone(fusion=fusion)
    jparams = dict(params)
    if fusion == "concat":  # the classifier takes the three embeddings side by side
        jparams["fc"] = {"kernel": np.tile(np.asarray(params["fc"]["kernel"]), (3, 1)) / 3.0,
                         "bias": np.asarray(params["fc"]["bias"])}
    want = np.asarray(module.apply({"params": jparams}, *map(jnp.asarray, (x, pad, meta, img, spec)),
                                   deterministic=True))
    tcfg = load_defaults()
    for k, v in TINY + [("train.compute_dtype", "float32"), ("model.AppleCider.fusion", fusion)]:
        tcfg.set(k, v)
    port = build_fusion_model(tcfg, device="cpu")
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams)))
    with torch.inference_mode():
        got = port(*map(torch.from_numpy, (x, pad, meta, img, spec))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _jax_fused(task, params, samples, n_rows=8):
    """JAX FusedSpectraStream at one fixed shape (rows padded to n_rows,
    spectra bucket 8, length bucket 32), so that one compile serves all."""
    jf = js.FusedSpectraStream(task, spec_buckets=(8,), wave_grid=GRID)
    placed = jf.place(samples, length_buckets=(32,), pad_to=n_rows)
    return np.asarray(jf.run_placed(params, placed)())[: len(samples)]


def _mk(rng, flags):
    samples = make_alert_samples(len(flags), seed=int(rng.integers(1 << 30)), spectrum_frac=0.0,
                                 length_range=(3, 32), spectrum_points=(2, 2))
    for s, f in zip(samples, flags):
        if f:
            n = int(rng.integers(20, 700))  # > 512 points exercises decimation
            s["spec_wl"] = np.sort(rng.uniform(4000, 8500, n)).astype(np.float32)
            s["spec_flux"] = rng.normal(size=n).astype(np.float32)
    return samples


def test_fused_stream_matches_jax(pair, rng):
    task, params, model = pair
    port = ts.FusedSpectraStream(model, spec_buckets=(0, 2, 4, 8), wave_grid=GRID, device="cpu")
    for flags in ([True, False, True, False, False], [True] * 3, [False] * 3):
        samples = _mk(rng, flags)
        want = _jax_fused(task, params, samples)
        got = port(samples, length_buckets=(8, 16, 32))
        assert got.shape == (len(flags), 5)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"flags={flags}")
    assert port([]).shape == (0, 5)


def test_monolithic_pipeline_matches_jax(pair, rng):
    task, params, model = pair
    samples = _mk(rng, [True, False, True, True, False, False, True, False])
    raw = ts.pack_alert_batch(samples, max_photo=32, max_spec=512)
    got = ts.AlertStreamPipeline(model, wave_grid=GRID, device="cpu")(
        {k: torch.from_numpy(v) for k, v in raw.items()}).numpy()
    np.testing.assert_allclose(got, _jax_fused(task, params, samples), rtol=0, atol=1e-5)


def test_length_binned_feeder_matches_jax(pair, rng):
    task, params, model = pair
    samples = _mk(rng, [i % 3 == 0 for i in range(8)])
    want = _jax_fused(task, params, samples)
    port = ts.FusedSpectraStream(model, spec_buckets=(0, 2, 4, 8), wave_grid=GRID, device="cpu")
    feeder = ts.LengthBinnedFeeder(port, flush_bs=3, length_buckets=(8, 16, 32), device="cpu")
    got = np.full_like(want, np.nan)
    batches = feeder.submit(list(enumerate(samples))) + feeder.flush()
    assert feeder.flush() == []
    for indices, resolve in batches:
        probs = resolve()
        assert probs.shape[0] == len(indices)  # pad rows sliced off
        got[np.asarray(indices)] = probs
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_topk_mask_breaks_ties_like_jax(rng):
    """bf16 router gates tie often; the port keeps the lower expert index,
    as ``jax.lax.top_k`` does."""
    from applecider_tpu.ops.moe import topk_dense_dispatch as jax_dispatch
    from applecider_tpu.ops.moe import topk_mask as jax_topk_mask
    from applecider_tpu_torch.ops.moe import topk_dense_dispatch, topk_mask

    w = rng.integers(0, 3, size=(64, 4)).astype(np.float32) / 2.0  # many ties
    np.testing.assert_array_equal(topk_mask(torch.from_numpy(w), 2).numpy(),
                                  np.asarray(jax_topk_mask(jnp.asarray(w), 2)))
    outs = rng.normal(size=(64, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        topk_dense_dispatch(torch.from_numpy(outs), torch.from_numpy(w)).numpy(),
        np.asarray(jax_dispatch(jnp.asarray(outs), jnp.asarray(w))), rtol=1e-6, atol=1e-6)
