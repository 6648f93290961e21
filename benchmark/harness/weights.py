"""The weights of a run, made on the device from the seed in one call.

One uniform draw in [-1, 1) covers every parameter; each leaf takes its
slice, scaled by 1 / sqrt(fan in) for a matrix or a kernel, centred on 1
(+-0.25) for a norm's scale, and +-0.1 for any other vector. So every layer
contributes to the output, where the program's own initialisation makes
some nearly silent (ConvNeXt's layer scale starts at 1e-6). The same
``make_state`` gives the program its weights and, after the window, the
reference the same ones again.
"""

from __future__ import annotations

import math

import torch


def leaf_scale(name: str, shape) -> tuple[float, float]:
    """(offset, scale) of a leaf's values: offset + scale * U[-1, 1)."""
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    parent, _, leaf = name.rpartition(".")
    if "norm" in parent.rpartition(".")[2] and leaf == "weight":
        return 1.0, 0.25
    return 0.0, 0.1


def make_state(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor} for {name: shape}, from ``seed``; the leaves
    take their slices in the order of their names, so that any module with
    these names and shapes gets the same values."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    state, offset = {}, 0
    for name in sorted(shapes):
        shape = shapes[name]
        n = math.prod(shape)
        base, scale = leaf_scale(name, shape)
        state[name] = flat[offset: offset + n].view(shape).mul_(scale).add_(base)
        offset += n
    return state


def shapes_of(module: torch.nn.Module) -> dict:
    return {name: tuple(p.shape) for name, p in module.named_parameters()}


@torch.no_grad()
def load(module: torch.nn.Module, state: dict) -> None:
    """Copy ``state`` into every parameter of ``module`` (names must match)."""
    params = dict(module.named_parameters())
    if set(params) != set(state):
        raise KeyError(f"parameters and state differ: {sorted(set(params) ^ set(state))[:8]}")
    for name, p in params.items():
        p.copy_(state[name])
