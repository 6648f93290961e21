"""The mesh of ranks and the data-parallel helpers (counterpart of
``applecider_tpu/parallel/mesh.py``).

Where JAX lays devices out in a ``jax.sharding.Mesh``, the port lays out the
ranks of the ``torch.distributed`` process group, one process per card, as
a grid with the same axes:

* ``data``: each rank along it holds its slice of dim 0 of every batch and a
  replica of the parameters; the gradient is all-reduced over it as a mean
  (``train.trainer.Trainer``), so the step's loss, gradient and metrics are
  those of the global batch, as in the JAX step, which is one program over
  global arrays;
* ``model``: replicas; ranks that share a data index get the same rows. The
  JAX Trainer never applies ``expert_sharding_rules`` (it replicates the
  parameters), and nothing here does either.

Collectives run over NCCL for CUDA tensors and over gloo for the CPU. With
no process group the mesh is one rank and every helper is a no-op.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


class Mesh:
    """Ranks ``0 .. prod(shape) - 1`` of the default process group laid out
    row-major over ``axes`` (as JAX reshapes its device list), seen from
    rank ``rank``. ``groups`` maps each axis that collectives run over to
    the process group of the ranks that differ from this one only along it
    (None: the whole world); an axis of one rank among several has none.
    ``distributed`` says whether a process group is live."""

    def __init__(self, shape, axes=("data", "model"), rank: int = 0, groups: dict | None = None,
                 distributed: bool = False):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.groups = dict(groups or {})
        self.distributed = bool(distributed)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str = "data") -> int:
        """This rank's position along ``axis``."""
        if self.rank >= self.size:
            raise ValueError(f"rank {self.rank} is outside the mesh {self.shape}")
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[self.axis_names.index(axis)])

    def reduces(self, axis: str = "data") -> bool:
        """Whether collectives run along ``axis``."""
        return self.distributed and axis in self.groups

    def group(self, axis: str = "data"):
        return self.groups[axis]

    def __deepcopy__(self, memo):  # process groups are not copied
        return self

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, distributed={self.distributed})"


def make_mesh(shape=(-1, 1), axes=("data", "model")) -> Mesh:
    """The mesh of this process's group; -1 in ``shape`` absorbs the ranks
    left. A shape that needs more ranks than the world has raises; one that
    uses fewer warns, and the ranks past it are outside the mesh."""
    from applecider_tpu_torch.parallel.multihost import process_count, process_index

    n = process_count()
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    needed = math.prod(shape)
    if needed > n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {needed} devices, have {n}")
    if needed < n:
        warnings.warn(f"mesh shape {tuple(shape)} uses {needed} of {n} available devices; "
                      "use -1 in the shape to absorb the rest", stacklevel=2)
    live = dist.is_available() and dist.is_initialized()
    groups = {}
    if live:
        groups = _axis_groups(n, tuple(shape), tuple(axes))
    return Mesh(shape, axes, rank=process_index(), groups=dict(groups), distributed=live)


# (world size, shape, axes) -> (the default group they were made under, the
# axis groups of this rank): a mesh's groups are made once for the life of the
# process group, as a JAX ``Mesh`` costs nothing to build again
_GROUPS: dict = {}


def _axis_groups(n: int, shape: tuple, axes: tuple) -> dict:
    """This rank's process group along each axis of ``shape`` (None: the
    whole world, the default group; absent: one rank), made by every rank in
    the same order at the first call and reused while the default group
    lives."""
    from applecider_tpu_torch.parallel.multihost import process_index

    world = dist.group.WORLD
    key = (n, shape, axes)
    cached = _GROUPS.get(key)
    if cached is not None and cached[0] is world:
        return cached[1]
    groups = {}
    grid = np.arange(math.prod(shape)).reshape(shape)
    for a, axis in enumerate(axes):
        if shape[a] == n:
            groups[axis] = None  # the whole world: the default group
            continue
        if shape[a] == 1:
            continue  # one rank: nothing to reduce
        # every rank creates every group, in the same order
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            g = dist.new_group([int(r) for r in line])
            if process_index() in line:
                groups[axis] = g
    _GROUPS[key] = (world, groups)
    return groups


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> tuple:
    """Dim 0 split over ``axis``, the rest whole (JAX's ``P(axis, None, ...)``)."""
    return (axis,) + (None,) * (ndim - 1)


def _rows(x, mesh: Mesh, axis: str):
    n = mesh.shape[axis]
    shape = tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)
    if n == 1 or len(shape) == 0 or shape[0] == 0 or shape[0] % n:
        return x
    b = shape[0] // n
    i = mesh.index(axis)
    return x[i * b:(i + 1) * b]


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of every array leaf (NumPy or tensor) of ``batch``:
    dim 0 split evenly over ``axis``, in rank order. Leaves whose dim 0 is 0
    or does not divide (statistics vectors, ragged tails) stay whole on
    every rank."""
    if isinstance(batch, dict):
        return type(batch)((k, shard_batch(v, mesh, axis)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    return _rows(batch, mesh, axis)


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh | None = None) -> nn.Module:
    """Every parameter and buffer of ``module`` as rank 0 holds it."""
    if mesh is not None and mesh.distributed:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module


def data_sum(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """``x`` summed over ``mesh``'s data axis, through an all-reduce that
    autograd sees (the backward all-reduces the gradient); ``x`` itself
    without a process group."""
    if mesh is None or not mesh.reduces("data"):
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=mesh.group("data"))


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The ranks' row blocks of ``x`` concatenated in their order along
    ``axis``, on every rank; blocks may differ in length. ``x`` itself
    without a process group."""
    if not mesh.reduces(axis) or mesh.shape[axis] == 1:
        return x
    group = mesh.group(axis)
    n = mesh.shape[axis]
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    sizes = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(sizes, rows, group=group)
    sizes = [int(s.item()) for s in sizes]
    top = max(sizes)
    x = x.contiguous()
    if x.shape[0] < top:
        x = torch.cat([x, x.new_zeros((top - x.shape[0], *x.shape[1:]))])
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def expert_sharding_rules(module: nn.Module, mesh: Mesh, axis: str = "model") -> dict:
    """For each parameter of ``module``, the axis each dimension shards
    over: inside an ``expert_*`` submodule a parameter of two or more
    dimensions splits its output features over ``axis`` when they divide,
    everything else is replicated (``()``). The output features are flax's
    last axis, which the weight bridge moves to dim 0 of every ``weight``
    it transposes from a ``kernel``; other leaves keep flax's layout. Rules
    only: nothing on the training path applies them, as in JAX."""
    n = mesh.shape[axis]
    rules = {}
    for name, p in module.named_parameters():
        parts = name.split(".")
        spec: tuple = ()
        if any(s.startswith("expert_") for s in parts[:-1]) and p.dim() >= 2:
            dim = 0 if parts[-1] == "weight" else p.dim() - 1
            if p.shape[dim] % n == 0:
                spec = tuple(axis if d == dim else None for d in range(p.dim()))
        rules[name] = spec
    return rules
