"""The port's ConvNeXt against the committed HuggingFace goldens
(``tests/goldens/convnext_tiny_in{3,4}_hf.npz``): transformers' own
ConvNeXt, independent of this repo, on weights regenerated from a seed by
``tests/golden_weights.py``, as ``tests/test_timm_goldens.py`` holds the
JAX ConvNeXt (same bound, 1e-4)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from applecider_tpu.utils.torch_port import convnext_params
from applecider_tpu_torch.models.convnext import ConvNeXt
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.golden_weights import convnext_random_sd

HF_GOLDENS = sorted((Path(__file__).parent / "goldens").glob("convnext_tiny_in*_hf.npz"))


def test_goldens_present():
    assert [p.name for p in HF_GOLDENS] == ["convnext_tiny_in3_hf.npz", "convnext_tiny_in4_hf.npz"]


@pytest.mark.parametrize("path", HF_GOLDENS, ids=lambda p: p.stem)
def test_port_convnext_matches_transformers_golden(path):
    z = np.load(path)
    depths = tuple(int(d) for d in z["depths"])
    dims = tuple(int(d) for d in z["dims"])
    x = z["input"]  # NCHW, as transformers takes it
    sd = convnext_random_sd(depths, dims, x.shape[1], int(z["seed"]))
    model = ConvNeXt(depths, dims, in_chans=x.shape[1])
    model.load_state_dict(from_jax_params(convnext_params(sd, depths)), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 3, 1)))).numpy()
    assert got.shape == z["output"].shape
    assert float(np.max(np.abs(got - z["output"]))) < 1e-4
