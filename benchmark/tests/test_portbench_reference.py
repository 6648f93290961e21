"""The plain reference against the program at a tiny width, with the same
weights: the fusion forward, the SpectraNet classifier, and the serving
preprocessing. The test imports both; the reference imports nothing of the
program."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import common, traffic, weights
from benchmark.reference import applecider_fusion as fusion_ref
from benchmark.reference import preprocess
from benchmark.reference import spectranet as spectra_ref
from benchmark.tests.tiny import MODEL

CFG = {"model": dict(MODEL, name="AppleCider"), "train": {"compute_dtype": "float32"}}


def program_task(cfg):
    return common.build_task(common.port_config(cfg), torch.device("cpu"))


def same_weights(program, reference, seed=3):
    state = weights.make_state(weights.shapes_of(program), seed, "cpu")
    weights.load(program, state)
    reference.load_state_dict(weights.make_state(weights.shapes_of(reference), seed, "cpu"))


def test_fusion_forward_matches_the_program():
    task = program_task(CFG)
    ref = fusion_ref.build(CFG).eval()
    same_weights(task.module, ref)
    rng = np.random.default_rng(0)
    B, L = 4, 40
    pad = np.zeros((B, L), bool)
    pad[1, 30:] = pad[3, 5:] = True
    args = [torch.from_numpy(a) for a in (
        rng.normal(size=(B, L, 7)).astype(np.float32), pad,
        rng.normal(size=(B, 24)).astype(np.float32),
        rng.normal(size=(B, 63, 63, 3)).astype(np.float32),
        rng.normal(size=(B, 3481)).astype(np.float32))]
    with torch.no_grad():
        got = task.module.eval()(*args, kernels=False)
        want = ref(*args)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4), (got - want).abs().max()


def test_spectranet_classifier_matches_the_program():
    cfg = {"model": {"name": "SpectraNet", "SpectraNet": MODEL["SpectraNet"]},
           "train": {"compute_dtype": "float32"}}
    task = program_task(cfg)
    ref = spectra_ref.build(cfg).eval()
    same_weights(task.module, ref)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 3481)).astype(np.float32))
    with torch.no_grad():
        got = task.module.eval()(x, kernels=False)
        want = ref(x)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


def test_preprocessing_matches_the_program():
    from applecider_tpu_torch.infer.stream import FusedSpectraStream, pack_compact

    task = program_task(CFG)
    mean, std = np.array([2.0, 1.0, 3.0, -1.0]), np.array([1.5, 1.0, 1.0, 0.5])
    stream = FusedSpectraStream(task.module, stats_mean=mean, stats_std=std, horizon_days=100.0,
                                device="cpu")
    p = {"pool": 24, "length": [20, 257], "days": 120.0, "spectrum_frac": 0.5,
         "spectrum_points": [80, 2000]}
    alerts = traffic.alert_pool(p, 5)
    raw = pack_compact(alerts, stream.spec_buckets)
    with torch.no_grad():
        got = stream.pipe.preprocess({k: torch.from_numpy(v) for k, v in raw.items()})
    spectra = got["spectra"][got["spec_gather"]].numpy()
    for i, a in enumerate(alerts):
        want = preprocess.alert_inputs(a, 100.0, mean, std)
        n = len(want["photometry"])
        assert not got["photo_mask"][i, :n].any() and got["photo_mask"][i, n:].all()
        np.testing.assert_allclose(got["photometry"][i, :n].numpy(), want["photometry"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["metadata"][i].numpy(), want["metadata"], rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_allclose(spectra[i], want["spectrum"], rtol=1e-3, atol=1e-3)
