"""int8 serving (``ops/quant.py``, ``ops/int8.py``) against the JAX
package's ``applecider_tpu/ops/quant.py`` on the CPU, where the int8
wrappers run their plain twins.

* The twins' int32 accumulators equal JAX's ``lax.dot_general`` /
  ``conv_general_dilated(preferred_element_type=int32)`` on the same int8
  operands exactly, and ``quant_dense``/``quant_conv`` equal JAX's within
  1e-6 x max|y| (f32): Linear K = 7, 19, 33, 64, M = 131, N = 4; conv1d
  'same' K = 3, 61 (Cin 3 and 1); conv2d 4x4/4, 2x2/2 and the depthwise 7x7
  pad 3 (C = 6, 16, 32, 48; images 9x9, 15x15, 3x3 and 1x1, the window
  wider than the image).
* The input and weight quantizers equal JAX's bit for bit, exact .5 ties
  (half to even) and values past +-127 included.
* Calibration gives JAX's key set, each scale within 1e-5 relative (the
  tiny fusion model, a 128-bin grid, JAX's convs direct).
* With JAX's scales, the port's int8 pipeline gives JAX's int8
  probabilities within 1e-3 and the same top-1 on every row; against its
  own f32 pipeline, top-1 >= 5/6 and mean |dp| < 0.03 (JAX's own bounds,
  ``tests/test_quant.py``); empty or unknown scales give the f32 output
  exactly.
* ``serve_alert_stream(int8=True)`` against JAX's on a tiny corpus, and
  ``rt.serve`` with ``serve.int8 = true`` equal to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.infer import serve as js
from applecider_tpu.infer import stream as js_stream
from applecider_tpu.ops import quant as jq
from applecider_tpu_torch.infer import serve as ts
from applecider_tpu_torch.infer import stream as ts_stream
from applecider_tpu_torch.models.convnext import Conv2dTorch
from applecider_tpu_torch.models.layers import Linear
from applecider_tpu_torch.models.spectranet import Conv1d
from applecider_tpu_torch.ops import int8
from applecider_tpu_torch.ops import quant as tq
from applecider_tpu_torch.testing import make_corpus
from tests.test_torch_pipeline import GRID, pair  # noqa: F401  (module fixture)

PATH = ("layer", "proj")  # a module path; its key is "layer/proj" in both packages
KEY = "/".join(PATH)

# name: (kind, x shape, weight shape in the port's layout, stride, padding, groups)
CASES = {
    "linear_k7": ("dense", (5, 9, 7), (16, 7), None, None, 1),
    "linear_k19": ("dense", (6, 19), (4, 19), None, None, 1),
    "linear_k64": ("dense", (3, 11, 64), (24, 64), None, None, 1),
    "conv1d_k3": ("conv1d", (2, 40, 5), (6, 5, 3), 1, 1, 1),
    "conv1d_k61": ("conv1d", (2, 90, 3), (4, 3, 61), 1, 30, 1),
    "conv2d_4x4s4": ("conv2d", (2, 15, 15, 3), (8, 3, 4, 4), 4, 0, 1),
    "conv2d_2x2s2": ("conv2d", (2, 7, 7, 8), (12, 8, 2, 2), 2, 0, 1),
    "dwconv_7x7": ("conv2d", (2, 9, 9, 6), (6, 1, 7, 7), 1, 3, 6),
    # the tensor-core kernel's tile edges: K not a multiple of 16 or 32,
    # M not a multiple of the 128-row tile, N = 4, and Cin = 1 (16 taps a
    # chunk) with the window past both ends of a short row
    "linear_k33": ("dense", (7, 33), (12, 33), None, None, 1),
    "linear_m_ragged": ("dense", (131, 64), (8, 64), None, None, 1),
    "linear_n4": ("dense", (3, 5, 128), (4, 128), None, None, 1),
    "conv1d_cin1_k61": ("conv1d", (2, 50, 1), (4, 1, 61), 1, 30, 1),
    # the depthwise tile kernel's paths: a window wider than the image (rows
    # wholly in the padding skipped), the centre tap alone, C = 16 (16-byte
    # loads) on ConvNeXt stage 0's image
    "dwconv_7x7_h3": ("conv2d", (2, 3, 3, 32), (32, 1, 7, 7), 1, 3, 32),
    "dwconv_7x7_h1": ("conv2d", (3, 1, 1, 48), (48, 1, 7, 7), 1, 3, 48),
    "dwconv_7x7_c16": ("conv2d", (2, 15, 15, 16), (16, 1, 7, 7), 1, 3, 16),
}


def _jax_layout(w: np.ndarray) -> np.ndarray:
    """The port's (out, in, *k) weight in the JAX layout (*k, in, out)."""
    return np.transpose(w, (*range(2, w.ndim), 1, 0)) if w.ndim > 2 else w.T


def _jax_acc(kind, qx, qw, stride, padding, groups) -> np.ndarray:
    qx, qw = jnp.asarray(qx), jnp.asarray(_jax_layout(qw))
    if kind == "dense":
        return np.asarray(jax.lax.dot_general(qx, qw, (((qx.ndim - 1,), (0,)), ((), ())),
                                              preferred_element_type=jnp.int32))
    nd = 1 if kind == "conv1d" else 2
    dims = ("NWC", "WIO", "NWC") if nd == 1 else ("NHWC", "HWIO", "NHWC")
    return np.asarray(jax.lax.conv_general_dilated(
        qx, qw, (stride,) * nd, [(padding, padding)] * nd, dimension_numbers=dims,
        feature_group_count=groups, preferred_element_type=jnp.int32))


def _port_acc(kind, qx, qw, stride, padding, groups) -> np.ndarray:
    qx, qw = torch.from_numpy(qx), torch.from_numpy(qw)
    if kind == "dense":
        acc = int8.gemm(qx.reshape(-1, qx.shape[-1]), qw, None, None, torch.int32)
        return acc.reshape(*qx.shape[:-1], -1).numpy()
    if kind == "conv1d":
        return int8.conv2d(qx[:, None], qw[:, :, None], None, None, torch.int32, (1, stride),
                           (0, padding), groups)[:, 0].numpy()
    return int8.conv2d(qx, qw, None, None, torch.int32, (stride, stride), (padding, padding),
                       groups).numpy()


def _port_module(kind, w, bias, stride, padding, groups):
    cout = w.shape[0]
    if kind == "dense":
        m = Linear(w.shape[1], cout)
    elif kind == "conv1d":
        m = Conv1d(w.shape[1], cout, w.shape[2])
    else:
        m = Conv2dTorch(w.shape[1] * groups, cout, w.shape[2], stride=stride, groups=groups,
                        padding=padding)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        m.bias.copy_(torch.from_numpy(bias))
    m.quant_path = KEY
    return m


@pytest.mark.parametrize("name", list(CASES))
def test_accumulator_and_output_equal_jax(name):
    kind, xs, ws, stride, padding, groups = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    qx = rng.integers(-127, 128, size=xs).astype(np.int8)
    qw = rng.integers(-127, 128, size=ws).astype(np.int8)
    acc = _port_acc(kind, qx, qw, stride, padding, groups)
    want = _jax_acc(kind, qx, qw, stride, padding, groups)
    assert acc.dtype == want.dtype == np.int32 and acc.shape == want.shape
    np.testing.assert_array_equal(acc, want)

    # the whole int8 layer: quantize, product, dequantize, bias
    x = rng.normal(size=xs).astype(np.float32)
    w = (rng.normal(size=ws) * 0.2).astype(np.float32)
    bias = rng.normal(size=ws[0]).astype(np.float32)
    s_in = float(np.abs(x).max()) * 0.9  # some inputs past the scale: clamped
    with jq.quantized({KEY: s_in}):
        if kind == "dense":
            jy = jq.quant_dense(jnp.asarray(x), jnp.asarray(_jax_layout(w)), jnp.asarray(bias),
                                PATH, jnp.float32)
        else:
            nd = 1 if kind == "conv1d" else 2
            jy = jq.quant_conv(
                jnp.asarray(x), jnp.asarray(_jax_layout(w)), jnp.asarray(bias), PATH, jnp.float32,
                dimension_numbers=("NWC", "WIO", "NWC") if nd == 1 else ("NHWC", "HWIO", "NHWC"),
                window_strides=(stride,) * nd, padding=[(padding, padding)] * nd,
                feature_group_count=groups)
    jy = np.asarray(jy)
    m = _port_module(kind, w, bias, stride, padding, groups)
    with tq.quantized({KEY: s_in}), torch.no_grad():
        xt = torch.from_numpy(x)
        if kind == "dense":
            got = m(xt)
        elif kind == "conv1d":
            got = tq.quant_conv(xt, m, xt.dtype, padding=padding)
        else:
            got = m(xt)
    assert got.dtype == torch.float32 and got.shape == jy.shape
    np.testing.assert_allclose(got.numpy(), jy, rtol=0, atol=1e-6 * float(np.abs(jy).max()))


def test_int8_timed_shapes_are_spectranets():
    """The convolutions that chip_smoke.py and tools/int8_timing.py time on
    the card include every SpectraNet bank convolution and 1x1 downsample
    at its stage's length and channels, on the serving spectra block."""
    from applecider_tpu_torch.models.spectranet import DEFAULT_BANKS, SPECTRUM_BINS
    from applecider_tpu_torch.tools.int8_timing import INT8_CONVS, SPEC_BLOCK

    timed = {row[1:] for row in INT8_CONVS}
    want, cin, length = set(), 1, SPECTRUM_BINS
    for stage, (cout, bank) in enumerate(zip((64, 128, 256, 512, 1024), DEFAULT_BANKS)):
        want |= {(SPEC_BLOCK, 1, length, cin, cout, 1, k, 1, k // 2) for k in bank}
        if stage < 4:
            want.add((SPEC_BLOCK, 1, length, cout * len(bank), cout, 1, 1, 1, 0))
            length //= 4
        cin = cout
    assert want <= timed, sorted(want - timed)


def test_int8_timed_depthwise_shapes_are_convnexts():
    """The depthwise convolutions that chip_smoke.py and
    tools/int8_timing.py time on the card are exactly the depthwise layers
    of the port's default ConvNeXt on a 63x63 stamp: each image and C with
    its launches a forward, 7x7 pad 3 stride 1, at the serving batch."""
    from collections import Counter

    from applecider_tpu_torch.models.convnext import ConvNeXt
    from applecider_tpu_torch.tools.int8_timing import DWCONV_KERNEL, DWCONV_PAD, INT8_DWCONVS

    model = ConvNeXt()
    seen = Counter()

    def hook(m, args):
        _, H, W, C = args[0].shape
        seen[(H, W, C, m.weight.shape[-1], m.padding, m.stride)] += 1

    for m in model.modules():
        if isinstance(m, Conv2dTorch) and m.groups > 1:
            m.register_forward_pre_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 63, 63, 3))
    timed = Counter({(H, W, C, DWCONV_KERNEL, DWCONV_PAD, 1): n
                     for _, _, H, W, C, n in INT8_DWCONVS})
    assert seen == timed
    assert {row[1] for row in INT8_DWCONVS} == {512}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_equal_jax_bit_for_bit(dtype):
    """Half-to-even ties: s_in = 127 makes the scale 1, so x = k + 0.5 is
    an exact tie; values past +-127 clamp. Random values at a random
    scale, and the weight quantizer (ties where max|w| = 127, s_w = 1)."""
    rng = np.random.default_rng(3)
    ties = np.arange(-130, 130, dtype=np.float32) + 0.5
    x = np.concatenate([ties, [-1000.0, -127.5, 127.5, 1000.0, 0.0, -0.0],
                        rng.normal(size=500) * 40]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for s_in in (127.0, float(rng.uniform(0.1, 50.0)), 3.3):
        want = np.asarray(jq._quantize_input(jnp.asarray(x).astype(jdt), s_in))
        got = tq.quantize_input(torch.from_numpy(x).to(tdt), s_in).numpy()
        np.testing.assert_array_equal(got, want)
    for shape in ((7, 9), (6, 5, 3), (4, 3, 2, 2)):  # Linear, conv1d, conv2d (out first)
        w = (rng.normal(size=shape) * 0.3).astype(np.float32)
        w[0] = np.round(rng.uniform(-127, 127, size=shape[1:])) + 0.5  # ties at s_w = 1
        w[0].flat[0] = 127.0
        w[1] = 0.0  # an all-zero channel: s_w = 1e-12
        jqw, jsw = jq._quantize_kernel(jnp.asarray(_jax_layout(w)), tuple(range(w.ndim - 1)))
        qw, s_w = tq.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(qw.numpy(), _port_layout(np.asarray(jqw)))
        np.testing.assert_array_equal(s_w.numpy(), np.asarray(jsw))


def _port_layout(w: np.ndarray) -> np.ndarray:
    """A JAX (*k, in, out) weight in the port's (out, in, *k) layout."""
    return w.T if w.ndim == 2 else np.transpose(w, (w.ndim - 1, w.ndim - 2, *range(w.ndim - 2)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir, _ = make_corpus(tmp_path_factory.mktemp("quant_serve"), n_objects=5, seed=7,
                              n_photometry=24, n_alerts=5)
    return data_dir


SERVE_KW = dict(batch_size=4, length_buckets=(64,), wave_grid=GRID, calib_alerts=8)


@pytest.fixture(scope="module")
def jax_int8(pair, corpus):  # noqa: F811
    """The JAX ``serve_alert_stream(int8=True)`` of the corpus: (its
    pairs, its summary, the placed batch it calibrated on as NumPy, the
    scales it calibrated). One eager JAX calibration serves every test
    here: it is most of the file's time."""
    task, params, _ = pair
    pairs = list(js.iter_alert_samples(corpus))
    seen = {}
    inner = js_stream.AlertStreamPipeline.calibrate

    def recorded(self, params, raws, percentile_headroom=1.0):
        seen["raws"] = [{k: np.array(v) for k, v in r.items()} for r in raws]
        seen["scales"] = inner(self, params, raws, percentile_headroom)
        return seen["scales"]

    js_stream.AlertStreamPipeline.calibrate = recorded
    try:
        summary = js.serve_alert_stream(task, params, iter(pairs), int8=True, **SERVE_KW)
    finally:
        js_stream.AlertStreamPipeline.calibrate = inner
    (raw,) = seen["raws"]
    return pairs, summary, raw, seen["scales"]


def _t(raw):
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _probs(summary) -> np.ndarray:
    return np.stack([r["probs"] for r in summary["results"]])


def _port_scales(model, raw) -> dict:
    return ts_stream.FusedSpectraStream(model, wave_grid=GRID, device="cpu").pipe.calibrate(
        [_t(raw)])


def test_calibration_matches_jax(pair, jax_int8):  # noqa: F811
    """The port's calibration on the batch JAX calibrated on (the corpus'
    first alerts, spectrum carriers read ahead): JAX's key set, each scale
    within 1e-5 relative."""
    _, _, model = pair
    _, _, raw, jscales = jax_int8
    tscales = _port_scales(model, raw)
    assert len(jscales) > 10  # every Linear and conv saw an input
    assert set(tscales) == set(jscales)
    for k, v in jscales.items():
        assert abs(tscales[k] - v) <= 1e-5 * v, (k, tscales[k], v)


def test_int8_pipeline_matches_jax(pair, jax_int8):  # noqa: F811
    """JAX's scales fed to the port's quantized router: the rows JAX's
    int8 serve gave, within 1e-3, with the same top-1."""
    _, _, model = pair
    pairs, want, _, jscales = jax_int8
    router = ts_stream.FusedSpectraStream(model, wave_grid=GRID, quantize_scales=jscales,
                                          device="cpu")
    feeder = ts_stream.LengthBinnedFeeder(router, flush_bs=4, length_buckets=(64,), device="cpu")
    got = np.zeros_like(_probs(want))
    for idx, resolve in feeder.submit(list(enumerate(s for _, s in pairs))) + feeder.flush():
        got[np.asarray(idx)] = resolve()
    w = _probs(want)
    assert float(np.abs(got - w).max()) <= 1e-3
    np.testing.assert_array_equal(got.argmax(1), w.argmax(1))


def test_serve_alert_stream_int8_matches_jax(pair, jax_int8):  # noqa: F811
    """The port's ``serve_alert_stream(int8=True)``, its own head and
    read-ahead and its own calibration, against JAX's."""
    _, _, model = pair
    pairs, want, _, _ = jax_int8
    got = ts.serve_alert_stream(model, iter(pairs), int8=True, device="cpu", **SERVE_KW)
    assert got["n_alerts"] == want["n_alerts"] == len(pairs)
    rep = tq.quant_error_report(_probs(want), _probs(got))
    assert rep["top1_agreement"] == 1.0 and rep["max_abs_prob_diff"] <= 1e-3, rep
    # the summary names the scales it served with and its forwards (one
    # length bucket: a batch of 4 alerts a forward)
    assert set(got["quant_scales"]) == set(jax_int8[3])
    assert got["batches"] == -(-len(pairs) // SERVE_KW["batch_size"])


def test_prepared_layers_equal_per_call_quantization(pair, jax_int8):  # noqa: F811
    """A pipeline built with scales quantizes each layer once
    (``ops.quant.prepare``); its rows equal, bit for bit, those of
    ``quantized(scales)`` quantizing the weights on every call."""
    _, _, model = pair
    raw, scales = _t(jax_int8[2]), jax_int8[3]
    router = ts_stream.FusedSpectraStream(model, wave_grid=GRID, quantize_scales=scales,
                                          device="cpu")
    assert set(router.pipe.quant_layers) == set(scales)
    got = router.pipe(raw)
    with tq.quantized(scales):
        want = ts_stream.FusedSpectraStream(model, wave_grid=GRID, device="cpu").pipe(raw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_int8_serving_close_to_f32(pair, jax_int8):  # noqa: F811
    """The port's own int8 against its f32 serve (``tests/test_quant.py``'s
    bounds: top-1 >= 5/6, mean |dp| < 0.03), rows summing to 1."""
    _, _, model = pair
    pairs = jax_int8[0]
    ref = _probs(ts.serve_alert_stream(model, iter(pairs), device="cpu", **SERVE_KW))
    got = _probs(ts.serve_alert_stream(model, iter(pairs), int8=True, device="cpu", **SERVE_KW))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-4)
    rep = tq.quant_error_report(ref, got)
    assert rep["top1_agreement"] >= 5 / 6
    assert rep["mean_abs_prob_diff"] < 0.03
    assert rep["max_abs_prob_diff"] > 0  # int8 really ran


@pytest.mark.parametrize("scales", [{}, {"nope": 1.0}])
def test_empty_or_unknown_scales_are_exact_f32(pair, jax_int8, scales):  # noqa: F811
    _, _, model = pair
    raw = _t(jax_int8[2])
    ref = ts_stream.FusedSpectraStream(model, wave_grid=GRID, device="cpu").pipe(raw)
    got = ts_stream.FusedSpectraStream(model, wave_grid=GRID, device="cpu",
                                       quantize_scales=scales).pipe(raw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_runtime_serve_int8_equals_serve_alert_stream(pair, corpus, tmp_path):  # noqa: F811
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime
    from tests.test_torch_export import SERVING_TINY

    _, _, model = pair
    overrides = {**SERVING_TINY, "serve": {"batch_size": 4, "length_buckets": [32, 64],
                                           "int8": True}}
    rt = AppleCiderRuntime(overrides=overrides, workdir=tmp_path / "results", device="cpu")
    got = rt.serve(raw_path=corpus, params=model.state_dict())
    want = ts.serve_alert_stream(model, ts.iter_alert_samples(corpus), batch_size=4,
                                 length_buckets=(32, 64), int8=True, device="cpu")
    assert got["n_alerts"] == want["n_alerts"] > 0
    np.testing.assert_array_equal(np.stack([r["probs"] for r in got["results"]]),
                                  np.stack([r["probs"] for r in want["results"]]))
