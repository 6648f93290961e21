"""Backward rematerialisation in the port: ``train.remat`` (the whole loss
under an activation checkpoint) and ``model.BaselineCLS.remat`` (each
encoder layer under one, or "attn").

A step under every setting equals the plain step bit for bit, in the loss,
the gradients, the updated parameters and the run's generators afterwards,
for the fusion task, BaselineCLS and MPT at small widths with dropout 0.4
live: the recompute replays the K4 seeds, the dropout bits, MPT's mask and
PyTorch's default generators. The JAX step under ``jax.checkpoint`` with
``remat = true``, in its deterministic form, matches the port's at
``test_torch_train.py``'s tolerances (loss atol 1e-5; each gradient atol
1e-5 + 1e-4 * max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from applecider_tpu.config import load_defaults as jax_load_defaults
from applecider_tpu.models.baseline_cls import BaselineCLSTask as JaxBaselineCLSTask
from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.models import build_fusion_model, layers
from applecider_tpu_torch.models.base import Task, adam
from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
from applecider_tpu_torch.models.fusion import AppleCiderTask
from applecider_tpu_torch.models.layers import TransformerEncoder, resolve_remat
from applecider_tpu_torch.models.mpt import MPTTask
from applecider_tpu_torch.ops.dropout import DropoutRNG, checkpoint, replay_context_fn
from applecider_tpu_torch.train.trainer import Trainer
from applecider_tpu_torch.utils.weights import from_jax_params
from tests.test_torch_mpt import _batch as _photo_batch
from tests.test_torch_train import TINY, _batch as _fusion_batch

WIDTHS = {"d_model": 32, "n_heads": 2, "n_layers": 2, "dropout": 0.4}
SETTINGS = {  # name: (train.remat, model.BaselineCLS.remat)
    "plain": (False, "auto"),
    "train_remat": (True, "auto"),
    "layer_remat": (False, True),
    "attn": (False, "attn"),
    "both": (True, True),
}


def _cfg(family, train_remat, remat):
    cfg = load_defaults()
    if family == "fusion":
        for k, v in TINY:
            cfg.set(k, v)
    cfg.set("train.compute_dtype", "float32")
    for k, v in WIDTHS.items():
        cfg.set(f"model.BaselineCLS.{k}", v)
    cfg.set("model.BaselineCLS.remat", remat)
    cfg.set("train.remat", train_remat)
    return cfg


def _task(family, cfg):
    gen = torch.Generator().manual_seed(0)
    if family == "fusion":
        return AppleCiderTask(cfg, build_fusion_model(cfg, device="cpu", generator=gen))
    return {"cls": BaselineCLSTask, "mpt": MPTTask}[family](cfg, device="cpu", generator=gen)


def _host_batch(family):
    if family == "fusion":
        return _fusion_batch()
    x, pad, _ = _photo_batch(seed=1, B=6, L=20)
    return x, pad, np.arange(6) % 5


def _steps(family, setting, tmp_path, steps=2):
    """``steps`` train steps on one batch: per step the loss, gradients and
    parameters, then the next draw of every generator of the run."""
    cfg = _cfg(family, *SETTINGS[setting])
    trainer = Trainer(_task(family, cfg), cfg, tmp_path / setting, device="cpu", seed=3)
    torch.manual_seed(7)  # the default generators: AstroMiNN's and ConvNeXt's dropout
    batch = trainer.to_device(_host_batch(family))
    out = []
    for _ in range(steps):
        m = trainer.train_step(batch)
        params = dict(trainer.model.named_parameters())
        out.append((m["loss"].clone(), {n: p.grad.clone() for n, p in params.items()},
                    {n: p.detach().clone() for n, p in params.items()}))
    draws = (torch.randint(0, 2**31 - 1, (4,), generator=trainer.rng.cpu),
             torch.rand(4, generator=trainer.rng.device), torch.rand(4))
    return out, draws


@pytest.mark.parametrize("family", ["fusion", "cls", "mpt"])
def test_remat_step_equals_plain_step_bit_for_bit(family, tmp_path):
    want, want_draws = _steps(family, "plain", tmp_path)
    for setting in [s for s in SETTINGS if s != "plain"]:
        got, got_draws = _steps(family, setting, tmp_path)
        for (gl, gg, gp), (wl, wg, wp) in zip(got, want):
            assert torch.equal(gl, wl), (setting, float(gl), float(wl))
            for n in wg:
                assert torch.equal(gg[n], wg[n]), (setting, "grad", n)
                assert torch.equal(gp[n], wp[n]), (setting, "param", n)
        for g, w in zip(got_draws, want_draws):
            assert torch.equal(g, w), setting
    # dropout is live: the two steps drew different masks
    assert not torch.equal(want[0][0], want[1][0])


def _saved(module, x, pad):
    """Shapes and bytes of every tensor autograd saves outside a checkpoint
    during one training forward."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        module(x, pad)
    return shapes


def test_saved_tensors_attn_and_layer_remat(tmp_path):
    """"attn" saves no (B, H, L, L) tensor, and neither does the plain
    layer (K4 keeps q, k and v); ``remat = true`` saves less than plain."""
    x, pad, _ = _photo_batch(seed=2, B=4, L=16)
    x, pad = torch.from_numpy(x), torch.from_numpy(pad)
    B, H, L = 4, WIDTHS["n_heads"], 17  # the CLS token makes 17
    saved = {}
    for remat in ("auto", "attn", True):
        task = BaselineCLSTask(_cfg("cls", False, remat), device="cpu",
                               generator=torch.Generator().manual_seed(0))
        task.module.train()
        saved[remat] = _saved(task.module, x, pad)
        assert (B, H, L, L) not in saved[remat]
    nbytes = {k: sum(int(np.prod(s)) for s in v) for k, v in saved.items()}
    assert nbytes["attn"] == nbytes["auto"]
    assert nbytes[True] < nbytes["auto"] / 2, nbytes


def test_layer_remat_first_pass_runs_k4(tmp_path, monkeypatch):
    """Under ``remat = true`` every layer's first pass and its recompute go
    through K4's autograd function (``flash_attention``), never through
    K2's wrapper: the checkpoint is non-reentrant, so the first pass keeps
    autograd and the attention keeps its training route."""
    calls = []
    real = layers.flash_attention

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("the training forward reached K2")

    monkeypatch.setattr(layers, "flash_attention", counted)
    monkeypatch.setattr(layers, "masked_attention", refuse)
    monkeypatch.setattr(layers, "masked_attention_reference", refuse)
    cfg = _cfg("cls", False, True)
    trainer = Trainer(_task("cls", cfg), cfg, tmp_path, device="cpu", seed=3)
    trainer.train_step(trainer.to_device(_host_batch("cls")))
    assert calls == [True] * (2 * WIDTHS["n_layers"])  # first pass, then the recompute


def test_replay_restores_generators_after_an_early_stop():
    """The recompute context sets the generators to their state at entry
    and puts back the state it found on exit, also when the recompute stops
    early (an exception inside it)."""
    rng = DropoutRNG(5)
    forward, recompute = replay_context_fn([rng])()
    with forward:
        first = torch.rand(3, generator=rng.device), torch.randint(0, 9, (3,), generator=rng.cpu)
    after = rng.get_state()
    with pytest.raises(KeyError):
        with recompute:
            again = torch.rand(3, generator=rng.device), torch.randint(0, 9, (3,), generator=rng.cpu)
            raise KeyError("stop")
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.equal(a, b) for a, b in zip(rng.get_state(), after))


def test_checkpoint_replays_draws_in_the_recompute():
    """A region that draws from a ``DropoutRNG``: its gradient is the
    gradient of the forward that ran (the recompute drew the same mask)."""
    rng = DropoutRNG(1)
    x = torch.randn(64, requires_grad=True)

    def region(t):
        return t * (torch.rand(t.shape, generator=rng.device) > 0.5)

    y = checkpoint(region, x, rngs=[rng])
    mask = (y.detach() != 0).float()
    y.sum().backward()
    assert torch.equal(x.grad, mask)


class _BatchNormTask(Task):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.module = nn.Sequential(nn.Linear(3, 4), nn.BatchNorm1d(4))

    def loss(self, batch, train=True, kernels=True):
        self.module.train(train)
        loss = self.module(batch[0]).square().mean()
        return loss, {"metrics": {"loss": loss}}

    def make_optimizer(self, params):
        return adam(params, 1e-3)


def test_train_remat_refuses_a_forward_that_moves_buffers(tmp_path):
    """A BatchNorm in training mode updates its running statistics in the
    forward; the recompute would update them twice, so ``train.remat``
    raises rather than training on."""
    cfg = load_defaults()
    cfg.set("train.remat", True)
    trainer = Trainer(_BatchNormTask(cfg), cfg, tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="running_mean"):
        trainer.train_step((torch.randn(8, 3),))


def test_remat_values_resolve_or_raise():
    assert [resolve_remat(v) for v in ("auto", False, "false", "", True, "true", "layer", "attn")] \
        == [False, False, False, False, True, True, True, "attn"]
    with pytest.raises(ValueError, match="remat"):
        resolve_remat("attention")
    with pytest.raises(ValueError, match="remat"):
        TransformerEncoder(1, 8, 1, 16, remat="full")
    cfg = load_defaults()
    cfg.set("train.remat", "yes")
    with pytest.raises(ValueError, match="train.remat"):
        Trainer(_BatchNormTask(cfg), cfg, "unused", device="cpu")


def test_remat_step_matches_jax_checkpoint(tmp_path):
    """JAX's ``jax.checkpoint(loss_fn)`` with ``remat = true`` in its
    deterministic form against the port's ``Trainer.loss`` under
    ``train.remat`` and ``remat = true`` in eval mode with autograd on."""
    jcfg = jax_load_defaults()
    for k, v in {**WIDTHS, "dropout": 0.0, "remat": True}.items():
        jcfg.set(f"model.BaselineCLS.{k}", v)
    jcfg.set("train.compute_dtype", "float32")
    jtask = JaxBaselineCLSTask(jcfg)
    batch = _host_batch("cls")
    params = jtask.init(jax.random.PRNGKey(0), batch)["params"]
    loss_fn = jax.checkpoint(jtask.loss_fn, static_argnums=(3,))
    (loss, _), grads = jax.jit(lambda p, b: jax.value_and_grad(loss_fn, has_aux=True)(
        p, b, jax.random.PRNGKey(1), False))(params, tuple(jnp.asarray(a) for a in batch))

    cfg = _cfg("cls", True, True)
    task = BaselineCLSTask(cfg, device="cpu")
    task.module.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params)))
    trainer = Trainer(task, cfg, tmp_path, device="cpu")
    got, _ = trainer.loss(trainer.to_device(batch), train=False)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-5
    for name, g in from_jax_params(jax.tree.map(np.asarray, grads)).items():
        g = g.numpy()
        np.testing.assert_allclose(dict(task.module.named_parameters())[name].grad.numpy(), g,
                                   rtol=0, atol=1e-5 + 1e-4 * float(np.abs(g).max()),
                                   err_msg=name)
