"""The port's model zoo (``applecider_tpu_torch/models/zoo.py``) against the
JAX package's on the CPU, at small widths in f32.

For each of the seven baselines: the port's weights (its own draw) are
laid out as the flax module's ``params`` and ``batch_stats`` (the tree
from ``jax.eval_shape`` of the flax init, leaf by leaf of the same shape)
and carried back into the port by ``from_jax_params`` with a strict
``load_state_dict``, and one jitted JAX function gives the reference on
them: ``predict`` (probabilities) and the train-mode loss, logits and
gradients (dropout 0). The port's task,
sized by ``init`` on the same ``to_tensor`` batch, must agree within 1e-4.
SpectraEfficientNetV2's train mode normalises with the batch's statistics
as the JAX ``apply(..., mutable=["batch_stats"])`` does, and its buffers do
not move. Informer's heads with a mask and its distilling stages (L 40
-> 20 -> 10) are held at the module level.
"""

from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models import zoo as jzoo
from applecider_tpu.registry import get_model as jax_get_model
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.models import zoo
from applecider_tpu_torch.registry import get_model
from applecider_tpu_torch.models.layers import init_weights
from applecider_tpu_torch.utils.weights import _KERNEL_AXES, from_jax_params

TOL = 1e-4
B = 3
# (sample shape, [model.<name>] overrides): small widths, dropout 0
SPECS = {
    "BTSModel": ((31, 31, 3), {"conv1_channels": 4, "conv2_channels": 6, "dropout1": 0.0,
                               "dropout2": 0.0}),
    "GalSpecNet": ((96,), {"conv_channels": [1, 4, 6, 5], "dropout": 0.0}),
    "MetaModel": ((24,), {"hidden_dim": 8, "dropout": 0.0}),
    "Informer": ((24, 7), {"d_model": 8, "n_heads": 2, "n_layers": 2, "distil": True,
                           "dropout": 0.0}),
    "SpectraViT": ((48, 48, 3), {"backbone_dim": 16, "backbone_depth": 1, "s_dim": 8,
                                 "dropout": 0.0}),
    "SpectraEfficientNetV2": ((32, 32, 3), {"arch": "tiny", "s_dim": 8, "head_features": 16,
                                            "dropout": 0.0}),
    "SpectraConvNeXt": ((33, 33, 3), {"depths": [1, 1], "dims": [4, 8]}),
}
# flax leaf names that the port renames
_PORT_NAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}
# the key of each model's input in the data dict
INPUT_KEY = {"BTSModel": "image", "GalSpecNet": "flux", "MetaModel": "metadata",
             "Informer": "photometry", "SpectraViT": "spectrum_image",
             "SpectraEfficientNetV2": "image", "SpectraConvNeXt": "x"}


def _configs(name: str):
    shape, overrides = SPECS[name]
    cfgs = (jax_load_defaults(), load_defaults())
    for cfg in cfgs:
        for k, v in {**overrides, "use_probabilities": True}.items():
            cfg.set(f"model.{name}.{k}", v)
        cfg.set("train.compute_dtype", "float32")
    return cfgs


def _data(name: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = SPECS[name][0]
    return {"data": {INPUT_KEY[name]: rng.normal(size=(B, *shape)).astype(np.float32),
                     "label": rng.integers(0, 5, size=B)}}


def _flat(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, k)))
        else:
            out[".".join((*prefix, k))] = np.asarray(v)
    return out


def _jax_layout(shapes: Mapping, state: dict, prefix=()) -> dict:
    """The port's ``state`` laid out as the flax tree ``shapes`` (``params``
    or ``batch_stats``, from ``jax.eval_shape`` of the flax init): the
    inverse of ``from_jax_params``. Every flax leaf must have a port
    tensor of its shape."""
    out = {}
    for key, leaf in shapes.items():
        if isinstance(leaf, Mapping):
            out[key] = _jax_layout(leaf, state, (*prefix, key))
            continue
        arr = state[".".join((*prefix, _PORT_NAMES.get(key, key)))].numpy()
        if key == "kernel":
            arr = arr.transpose(np.argsort(_KERNEL_AXES[arr.ndim]))
        assert arr.shape == leaf.shape, (prefix, key)
        out[key] = arr
    return out


def _carried(jax_module, port_module, *args, **kwargs) -> tuple[dict, dict | None]:
    """(flax params, batch_stats) holding ``port_module``'s weights, drawn
    by the port, their tree from the flax init traced with ``jax.eval_shape``
    (no XLA compile); ``port_module`` then reloads them strictly through
    ``from_jax_params``."""
    shapes = jax.eval_shape(lambda k: jax_module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    state = port_module.state_dict()
    params = _jax_layout(shapes["params"], state)
    stats = _jax_layout(shapes["batch_stats"], state) if "batch_stats" in shapes else None
    port_module.load_state_dict(from_jax_params(params, stats), strict=True)
    return params, stats


@pytest.mark.parametrize("name", list(SPECS))
def test_zoo_task_matches_jax(name):
    """Eval probabilities and loss, train-mode loss, logits and gradients
    (dropout 0) of each zoo task, the port's against the JAX task's on the
    same weights (the port's draw carried by ``from_jax_params``, loaded
    strictly), within 1e-4; ``to_tensor`` equal.

    SpectraEfficientNetV2's running statistics are moved off their init,
    so eval mode reads them; its train-mode logits are the JAX task's,
    which normalises with the batch's statistics through ``apply(...,
    mutable=["batch_stats"])`` and drops the averages it moves: the port's
    BatchNorm buffers stay bit for bit. The raw 3-D leaves ``token_kernel``
    and ``conv{i}_kernel`` are not named ``kernel``: ``from_jax_params``
    passes them through, and the port keeps them in the flax layout (K,
    Cin, Cout); the distilling conv's ``kernel`` becomes a conv1d
    ``weight`` (Cout, Cin, K)."""
    jcfg, cfg = _configs(name)
    jtask = jax_get_model(name)(jcfg)
    task = get_model(name)(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    data = _data(name, seed=7)
    jbatch, batch = jtask.to_tensor(data), task.to_tensor(data)
    for a, b in zip(jbatch, batch):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    module = task.init(batch)
    assert task.init(batch) is module  # sized once
    with torch.no_grad():
        for k, b in module.named_buffers():
            b.add_(0.1 * torch.rand(b.shape, generator=torch.Generator().manual_seed(len(k))))
    params, stats = _carried(jtask.module, module, jbatch[0], deterministic=True)
    jtask.batch_stats = stats

    @jax.jit
    def reference(params, x, labels):
        b = (x, labels)
        (loss, aux), grads = jax.value_and_grad(jtask.loss_fn, has_aux=True)(
            params, b, jax.random.PRNGKey(1), True)
        return jtask.predict(params, b), loss, aux["logits"], grads

    probs, loss, logits, grads = jax.device_get(
        reference(params, jnp.asarray(jbatch[0]), jnp.asarray(jbatch[1])))
    buffers = {k: v.clone() for k, v in module.named_buffers()}
    tb = tuple(torch.from_numpy(a) for a in batch)
    with torch.no_grad():
        np.testing.assert_allclose(task.predict(tb).numpy(), probs, rtol=TOL, atol=TOL)
        eval_loss = -np.mean(np.log(probs[np.arange(B), batch[1]]))
        np.testing.assert_allclose(float(task.loss(tb, train=False)[0]), eval_loss, rtol=TOL,
                                   atol=TOL)
    got, aux = task.loss(tb, train=True)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux["logits"].detach().numpy(), logits, rtol=TOL, atol=TOL)
    want = from_jax_params(grads)
    named = dict(module.named_parameters())
    assert set(want) == set(named)
    for k, g in want.items():
        np.testing.assert_allclose(named[k].grad.numpy(), g.numpy(), rtol=TOL, atol=TOL,
                                   err_msg=k)
    for k, b in module.named_buffers():
        assert torch.equal(b, buffers[k]), k
    assert (name == "SpectraEfficientNetV2") == bool(buffers) == (stats is not None)
    flat = _flat(params)
    raw = [k for k in flat if k.endswith("_kernel")]
    assert raw == (["token_kernel"] if name == "Informer" else
                   [f"conv{i}_kernel" for i in range(3)] if name == "GalSpecNet" else [])
    for k in raw:
        assert flat[k].shape[0] == (3 if name == "Informer" else 5)  # (K, Cin, Cout)
        np.testing.assert_array_equal(module.state_dict()[k].numpy(), flat[k])
    if name == "Informer":
        np.testing.assert_array_equal(module.distil_0.weight.detach().numpy(),
                                      flat["distil_0.kernel"].transpose(2, 1, 0))


@pytest.mark.parametrize("head,distil,n_layers", [("mean", False, 1), ("flatten", True, 3)])
def test_informer_heads_mask_and_distil_match_jax(head, distil, n_layers):
    """Informer with a valid-token mask (25 and 33 of 40 tokens): the mean
    head averages the valid embeddings; distilling takes L 40 -> 20 -> 10
    and pools the mask alongside (25 valid -> 13 -> 7), and the flatten
    head zeroes the embeddings the pooled mask calls padding, exactly;
    embeddings and logits within 1e-4 of JAX."""
    kw = dict(d_model=16, n_heads=2, n_layers=n_layers, num_classes=5, head=head,
              distil=distil, dropout=0.0)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, 7)).astype(np.float32)
    mask = np.zeros((2, 40), bool)
    mask[0, :25], mask[1, :33] = True, True
    m = jzoo.Informer(dtype=jnp.float32, **kw)
    port = init_weights(zoo.Informer((40, 7), dtype=torch.float32, **kw),
                        torch.Generator().manual_seed(1)).eval()
    params, _ = _carried(m, port, x, mask)
    emb_m = m.copy(classification=False)
    logits, emb = jax.device_get(jax.jit(lambda p: (
        m.apply({"params": p}, x, mask),
        emb_m.apply({"params": {k: v for k, v in p.items() if k != "fc"}}, x, mask)))(params))
    t_x, t_mask = torch.from_numpy(x), torch.from_numpy(mask)
    with torch.no_grad():
        np.testing.assert_allclose(port(t_x, t_mask).numpy(), logits, rtol=TOL, atol=TOL)
        port.fc = None
        got = port(t_x, t_mask).numpy()
    np.testing.assert_allclose(got, emb, rtol=TOL, atol=TOL)
    L = 10 if distil else 40
    assert got.shape == ((2, L * 16) if head == "flatten" else (2, 16))
    assert {f"distil_{i}" in params for i in range(n_layers - 1)} <= {distil}
    if head == "flatten":
        assert np.abs(got.reshape(2, L, 16)[0, 7:]).max() == 0.0
        assert np.abs(got.reshape(2, L, 16)[0, :7]).min() > 0.0


def test_zoo_registry_names_and_inputs():
    """Each name resolves short and JAX-dotted to the same task; every
    ``to_tensor`` takes the first input key present as the JAX task does
    and raises the same ``KeyError`` when none is."""
    for name, (cls, keys) in zoo.ZOO.items():
        task_cls = get_model(name)
        assert get_model(f"applecider_tpu.models.zoo.{name}Task") is task_cls
        assert get_model(f"applecider_tpu_torch.models.zoo.{name}Task") is task_cls
        assert task_cls.module_cls is cls and task_cls.input_keys == keys
        jax_cls = jax_get_model(name)
        for key in keys:
            data = {"data": {key: np.ones((2, 3)), "label": [1, 2], "other": np.zeros(2)}}
            for a, b in zip(jax_cls.to_tensor(data), task_cls.to_tensor(data)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        for cls_ in (jax_cls, task_cls):
            with pytest.raises(KeyError, match=f"{name} batch needs one of"):
                cls_.to_tensor({"data": {"nothing": np.zeros(2)}})
    task = get_model("MetaModel")(load_defaults(), device="cpu")
    with pytest.raises(RuntimeError, match="init"):
        task.module
