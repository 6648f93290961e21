"""The operation and byte counts of ``mfu.*`` and each ``*_roofline.*``
against counts made another way at small shapes: the model FLOPs against
PyTorch's FLOP counter over the plain reference, the kernels' bounds
against hand counts."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import readers, spec
from benchmark.reference import applecider_fusion as fusion_ref
from benchmark.reference import spectranet as spectra_ref
from benchmark.tests.tiny import MODEL

CFG = {"model": MODEL}


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("points", [1, 20, 257])
def test_fusion_forward_flops_match_the_flop_counter(points):
    torch.manual_seed(0)
    model = fusion_ref.build(CFG).eval()
    x = torch.randn(1, points, 7)
    args = (x, torch.zeros(1, points, dtype=torch.bool), torch.randn(1, 24),
            torch.randn(1, 63, 63, 3), torch.randn(1, 3481))
    with torch.no_grad():
        total = counted(lambda: model(*args))
        spectra = counted(lambda: model.spectra_encoder(args[4]))
    assert fusion_ref.forward_flops(CFG, points, True) == total
    assert fusion_ref.forward_flops(CFG, points, False) == total - spectra


def test_spectranet_classifier_flops_match_the_flop_counter():
    model = spectra_ref.build(CFG).eval()
    with torch.no_grad():
        total = counted(lambda: model(torch.randn(2, 3481)))
    assert 2 * spectra_ref.forward_flops(CFG, 3481, True) == total


def test_published_widths_by_hand():
    """A few terms at the published widths, counted by hand."""
    cfg = spec.read_json(spec.ROOT / "benchmark" / "configs" / "applecider_fusion.json")
    d, L = 128, 258
    per_layer = 2 * L * d * 3 * d + 4 * L * L * d + 2 * L * d * d + 2 * 2 * L * d * 4 * d
    assert fusion_ref.photometry_flops(cfg, 257) == 2 * 257 * 7 * d + 4 * per_layer
    stage0 = 2 * 3481 * 1 * 64 * (3 + 61 + 1021) + 2 * 3481 * 192 * 64
    assert fusion_ref.spectra_flops(cfg) > stage0
    assert fusion_ref.convnext_flops([0, 0, 0, 0], [96, 192, 384, 768]) == (
        2 * 15 * 15 * 48 * 96 + 2 * 7 * 7 * 4 * 96 * 192 + 2 * 3 * 3 * 4 * 192 * 384
        + 2 * 1 * 1 * 4 * 384 * 768)


class Call:
    def __init__(self, note, device_s):
        self.rec = {"note": note, "device_s": device_s, "host_s": 0.0}


def share(reader, args, device_s):
    note = reader.note(args, {}, None)
    r = type("R", (), {"calls": {reader.SPANS[0][0]: [Call(note, device_s).rec]},
                       "trace": {"busy_s": 1.0}})()
    return reader.read(r)


def test_kernel_bounds_by_hand():
    metric = spec.metric_reader
    bf16 = torch.bfloat16
    # K1: (B, P) t f32, band i32, valid bool read, ids i32 written
    t = torch.zeros(2, 3)
    assert share(metric("k1_roofline.serve"), (t,), 1.0) == pytest.approx(
        100 * 2 * 3 * 13 / readers.HBM_BYTES_PER_S)
    # K2: (B, H, L, hd) = (2, 2, 3, 8) in bf16
    q = torch.zeros(2, 2, 3, 8, dtype=bf16)
    io = 2 * 2 * 3 * 8 * 2
    ops = 4 * 2 * 2 * 3 * 3 * 8
    assert share(metric("k2_roofline.serve"), (q,), 1.0) == pytest.approx(
        100 * max((4 * io + 6) / 3.35e12, ops / 989e12))
    # at the serving shape, head width 16, K2 is bound by its bytes
    big = torch.zeros(512, 8, 256, 16, dtype=bf16)
    n = metric("k2_roofline.serve").note((big,), {}, None)
    assert metric("k2_roofline.serve").bound(n) == pytest.approx(
        (4 * 512 * 8 * 256 * 16 * 2 + 512 * 256) / 3.35e12)
    # K3f and K3b over N rows of C in f32
    x = torch.zeros(5, 7, 12)
    assert share(metric("k3f_roofline.serve"), (x,), 1.0) == pytest.approx(
        100 * max((2 * 35 * 12 * 4 + 2 * 12 * 4) / 3.35e12, 20 * 35 * 12 / 67e12))
    assert share(metric("k3b_roofline.train"), (x,), 1.0) == pytest.approx(
        100 * max((3 * 35 * 12 * 4 + 4 * 12 * 4) / 3.35e12, 40 * 35 * 12 / 67e12))


def test_mfu_and_idle_share():
    r = type("R", (), {"window": {"work": {"flops": 989e12}, "window_s": 4.0},
                       "trace": {"busy_s": 3.0, "window_s": 4.0}})()
    assert readers.mfu(r) == pytest.approx(25.0)
    assert readers.idle_share(r) == pytest.approx(25.0)
    r.trace = {"busy_s": 0.0, "window_s": 4.0}
    assert readers.ms_per_call(type("R", (), {"calls": {"x": [{"device_s": 0.0}]},
                                              "trace": r.trace})(), "x") is None
