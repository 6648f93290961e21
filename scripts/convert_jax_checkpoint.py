"""Carry a JAX run's checkpoint over to the PyTorch port.

Restores ``<run>/checkpoints/<tag>`` (the orbax checkpoint that
``applecider_tpu.train.trainer.Trainer`` writes) and writes
``<out>/checkpoints/<tag>.pt``, the port ``Trainer``'s checkpoint, so that a
port ``Trainer`` on ``<out>`` with ``checkpoint.resume`` carries the run on:

* ``params`` (and TriPool's ``batch_stats``) through
  ``applecider_tpu_torch.utils.weights.from_jax_params``, checked name by
  name and shape by shape against the port model the config builds;
* ``ema``, ``plateau``, ``step`` and ``epoch`` as they are;
* ``opt_state``: each optax ``ScaleByAdamState`` (``mu``, ``nu``,
  ``count``) becomes ``exp_avg``, ``exp_avg_sq`` and ``step`` of every
  parameter it holds, in the port optimizer's group order. This covers one
  Adam or AdamW chain (the fusion task, BaselineCLS, MPT, SpectraNet,
  TriPool) behind the clip, the freeze and the plateau scale, and
  AstroMiNN's 11 ``multi_transform`` groups. Any other layout, such as
  ``optax.MultiSteps`` under ``train.grad_accum_steps``, raises and names
  it; ``--params-only`` then writes everything but ``opt_state``, and the
  port starts its optimizer afresh.

It needs JAX and orbax (the port does not), so it lives outside both
packages. Run it from the repository root::

    python scripts/convert_jax_checkpoint.py --run results/<jax run> \\
        --config run.toml [--tag last] [--out results/<port run>] [--params-only]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from applecider_tpu_torch.config import Config, load_config  # noqa: E402
from applecider_tpu_torch.models.fusion import AppleCiderTask  # noqa: E402
from applecider_tpu_torch.registry import get_model  # noqa: E402
from applecider_tpu_torch.train.optim import trainable_parameters  # noqa: E402
from applecider_tpu_torch.utils.import_checkpoint import check_against  # noqa: E402
from applecider_tpu_torch.utils.weights import from_jax_params  # noqa: E402

ADAM = {"count", "mu", "nu"}
INJECT = {"count", "hyperparams", "hyperparams_states", "inner_state"}
MULTISTEPS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"}


class UnmappedOptState(ValueError):
    """An optax state layout that has no counterpart in the port's
    optimizer state."""


def restore_raw(path: Path) -> dict:
    """The orbax checkpoint at ``path`` as nested dicts and lists of NumPy
    arrays (namedtuples become dicts by field, tuples lists, empty states
    None)."""
    import jax
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(path.absolute())
    return jax.tree.map(np.asarray, restored)


def adam_states(node, where: str = "opt_state") -> list[dict]:
    """Every ``ScaleByAdamState`` in a restored optax state, in tree order;
    raises ``UnmappedOptState`` on any state it does not know."""
    if node is None:
        return []
    if isinstance(node, (list, tuple)):
        return [s for i, child in enumerate(node) for s in adam_states(child, f"{where}[{i}]")]
    if isinstance(node, dict):
        keys = set(node)
        if keys == ADAM:
            return [node]
        if keys == MULTISTEPS:
            raise UnmappedOptState(
                f"{where} is optax.MultiSteps (train.grad_accum_steps): its accumulated "
                "gradients have no place in the port's optimizer state")
        if keys == INJECT:  # the plateau scale; the checkpoint's 'plateau' carries it
            return adam_states(node["inner_state"], f"{where}.inner_state")
        if keys == {"inner_states"}:  # optax.multi_transform (freeze, AstroMiNN's groups)
            return [s for k, child in node["inner_states"].items()
                    for s in adam_states(child, f"{where}.inner_states[{k}]")]
        if keys == {"inner_state"}:  # optax.masked
            return adam_states(node["inner_state"], f"{where}.inner_state")
        raise UnmappedOptState(f"{where} has the optax state fields {sorted(keys)}")
    raise UnmappedOptState(f"{where} is an array the port's optimizer has no place for")


def _present(tree):
    """``tree`` without its masked (None) leaves."""
    if isinstance(tree, dict):
        kept = {k: _present(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items() if v is not None and not (isinstance(v, dict)
                                                                         and not v)}
    return tree


def build_task(cfg: Config):
    """The port task the config names, on the CPU."""
    name = cfg.get_path("model.name", default="BaselineCLS")
    built = get_model(name)(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return built if hasattr(built, "module") else AppleCiderTask(cfg, built)


def optimizer_state(task, cfg: Config, opt_state) -> dict:
    """The port optimizer's ``state_dict`` holding the JAX run's Adam
    moments and counts."""
    module = task.module
    trainable = trainable_parameters(module, cfg.get_path("train.freeze_params", []))
    optimizer = task.make_optimizer([p for _, p in trainable])
    names = {id(p): n for n, p in module.named_parameters()}
    found = {}
    for st in adam_states(opt_state):
        mu, nu = from_jax_params(_present(st["mu"])), from_jax_params(_present(st["nu"]))
        for n in mu:
            found[n] = {"step": torch.tensor(float(st["count"]), dtype=torch.float32),
                        "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    missing = [names[id(p)] for g in optimizer.param_groups for p in g["params"]
               if names[id(p)] not in found]
    if missing:
        raise UnmappedOptState(f"no Adam state holds the trainable parameters {missing}")
    for group in optimizer.param_groups:
        for p in group["params"]:
            optimizer.state[p] = found[names[id(p)]]
    return optimizer.state_dict()


def convert(run: Path, cfg: Config, tag: str = "last", params_only: bool = False) -> dict:
    """The port ``Trainer``'s checkpoint of the JAX run's ``tag``."""
    raw = restore_raw(run / "checkpoints" / tag)
    task = build_task(cfg)
    params = from_jax_params(raw["params"], raw.get("batch_stats"))
    check_against(task.module, params)
    task.module.load_state_dict(params, strict=True)
    state = {"params": params, "step": int(raw["step"]), "epoch": int(raw["epoch"])}
    if "ema" in raw:
        state["ema"] = from_jax_params(raw["ema"])
    if "plateau" in raw:
        best, bad, scale = (float(v) for v in raw["plateau"])
        state["plateau"] = [best, int(bad), scale]
    if not params_only:
        state["opt_state"] = optimizer_state(task, cfg, raw["opt_state"])
    return state


def main(argv=None) -> Path:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", required=True, help="the JAX run directory (holds checkpoints/)")
    ap.add_argument("--config", default=None, help="the run's TOML (defaults otherwise)")
    ap.add_argument("--tag", default="last")
    ap.add_argument("--out", default=None, help="the port's run directory (default: --run)")
    ap.add_argument("--params-only", action="store_true",
                    help="write no opt_state: the port starts its optimizer afresh")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    try:
        state = convert(Path(args.run), cfg, args.tag, args.params_only)
    except UnmappedOptState as e:
        raise SystemExit(f"{e}; rerun with --params-only to carry everything else") from e
    path = Path(args.out or args.run) / "checkpoints" / f"{args.tag}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, path)
    print(f"converted {args.run} ({args.tag}, step {state['step']}, epoch {state['epoch']}"
          f"{', no opt_state' if args.params_only else ''}) -> {path}")
    return path


if __name__ == "__main__":
    main()
