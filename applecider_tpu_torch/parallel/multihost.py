"""Multi-process hooks on ``torch.distributed`` (counterpart of
``applecider_tpu/parallel/multihost.py``).

One process drives one card, so a JAX device becomes a rank here: JAX's
single-process mesh over several devices and its multi-process pod both
become one ``torch.distributed`` process group. ``[parallel.multihost]`` in
the run TOML::

    [parallel.multihost]
    enable = true
    coordinator_address = "10.0.0.1:29500"  # or a URL ("tcp://...", "file://...");
                                            # unset: MASTER_ADDR:MASTER_PORT
    num_processes = 4                       # unset: WORLD_SIZE
    process_id = 0                          # unset: RANK
    backend = "nccl"                        # unset: nccl on a card, gloo on the CPU
    timeout_s = 300                         # the rendezvous and every collective

Under ``torchrun`` the environment carries all of it, so ``enable = true``
suffices, and each process takes the card ``LOCAL_RANK``. With the group up,
the Trainer:

* builds its mesh over the group's ranks (``parallel.mesh.make_mesh``);
* strides the ``DataLoader`` by the rank's data index, every shard cut to
  the common length, so all ranks run the same number of steps of the same
  shape (a rank that enters a collective the others never reach hangs);
* all-reduces the gradient, gathers the evaluation's rows
  (``allgather_host_rows``) so that every rank takes the same early-stop,
  plateau and best-checkpoint decisions, and writes files from rank 0;
* takes process 0's run-directory name (``broadcast_str``).

With no process group the world is one rank and every hook is a no-op.
"""

from __future__ import annotations

import datetime
import os
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def maybe_initialize(config=None, device=None) -> tuple[int, int]:
    """Start the process group from ``parallel.multihost`` when it is
    enabled; returns ``(process_index, process_count)``.

    A group that is already live wins (a launcher or a test started it),
    unless the config names a ``num_processes`` the live group does not
    have: continuing would train the full data set independently on each
    process, so that raises. Missing rendezvous settings raise before any
    peer is contacted. On a CUDA ``device`` without an index, the process
    takes the card ``LOCAL_RANK`` (else its rank modulo the cards)."""
    enable = bool(config.get_path("parallel.multihost.enable", False)) \
        if config is not None else False
    if not enable:
        return process_index(), process_count()

    def key(name):
        return config.get_path(f"parallel.multihost.{name}", None)

    want = key("num_processes")
    if _live():
        if want is not None and int(want) != dist.get_world_size():
            raise RuntimeError(
                f"parallel.multihost.num_processes = {want}, but the live process group has "
                f"{dist.get_world_size()} processes; refusing to run as independent processes")
        return process_index(), process_count()

    env = os.environ
    address = key("coordinator_address")
    if address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = want if want is not None else env.get("WORLD_SIZE")
    rank = key("process_id") if key("process_id") is not None else env.get("RANK")
    missing = [name for name, v in (
        ("parallel.multihost.coordinator_address or MASTER_ADDR and MASTER_PORT", address),
        ("parallel.multihost.num_processes or WORLD_SIZE", world),
        ("parallel.multihost.process_id or RANK", rank)) if v is None]
    if missing:
        raise ValueError(f"parallel.multihost.enable is set, but nothing gives {'; '.join(missing)} "
                         "(set them in [parallel.multihost] or launch with torchrun)")
    world, rank = int(world), int(rank)
    dev = torch.device("cuda" if device is None else device)
    backend = key("backend") or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = dev.index if dev.index is not None else int(
            env.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=address if "://" in address else f"tcp://{address}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=float(key("timeout_s") or DEFAULT_TIMEOUT_S)))
    return rank, world


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _batch_dim(batch) -> int:
    """The batch size: the most common leading dim over array leaves.

    Batch tensors dominate any ``to_tensor`` output and broadcast leaves
    (feature-statistics vectors) are the minority, so a majority vote holds
    where a divisibility check would not (a (4,) statistics vector on four
    processes is not a batch leaf)."""
    dims = Counter(_shape(x)[0] for x in _leaves(batch) if len(_shape(x)) >= 1 and _shape(x)[0] > 0)
    return dims.most_common(1)[0][0] if dims else 0


def host_local_batch_to_global(batch, mesh, axis: str = "data"):
    """This process's share of the global batch, checked.

    One process: ``shard_batch`` (the whole batch on a one-rank mesh).
    Several: each process passes its local rows, which are already its
    shard, and gets them back; a batch whose global rows (local rows times
    processes) do not divide the mesh's data axis raises, because uneven
    rows cannot shard (set ``data_loader.drop_last`` or a divisible batch)."""
    from applecider_tpu_torch.parallel.mesh import shard_batch

    if process_count() == 1:
        return shard_batch(batch, mesh, axis=axis)
    n = mesh.shape[axis]
    local_b = _batch_dim(batch)
    global_b = local_b * process_count()
    if local_b and global_b % n:
        raise ValueError(
            f"local batch {local_b} x {process_count()} processes = {global_b} global rows, "
            f"not divisible by the {n}-way '{axis}' mesh axis; use data_loader.drop_last or "
            "a divisible batch size")
    return batch


def local_rows(x, n_local: int | None = None) -> np.ndarray:
    """This process's rows of a result computed on its shard, as NumPy.

    With several processes the result must hold exactly the ``n_local`` rows
    this process fed in: a result that spans more (a replicated, full-span
    output) is refused, where slicing its first ``n_local`` rows would hand
    process 0's rows to every process."""
    arr = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if process_count() > 1 and n_local is not None and (arr.ndim == 0 or arr.shape[0] != n_local):
        raise ValueError(
            f"local_rows: the result has {arr.shape[0] if arr.ndim else 0} rows where this "
            f"process fed {n_local}; a replicated or full-span result is not this process's "
            "shard")
    return arr


def _collective_device(group=None) -> torch.device:
    """Where host data goes for a collective: the current card under NCCL,
    the CPU otherwise."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_host_rows(arr: np.ndarray, mesh=None) -> np.ndarray:
    """Concatenate the processes' row blocks (axis 0) in data-axis order.

    One process: the rows themselves. Several: every process receives the
    concatenation over the data axis of ``mesh`` (every process without a
    mesh), so metrics computed from it are equal everywhere. Blocks may
    differ in length."""
    arr = np.asarray(arr)
    if process_count() == 1:
        return arr
    from applecider_tpu_torch.parallel.mesh import gather_rows, make_mesh

    mesh = mesh or make_mesh()
    if not mesh.reduces("data"):  # one rank on the data axis
        return arr
    dev = _collective_device(mesh.group("data"))
    dtype = np.uint8 if arr.dtype == bool else arr.dtype
    out = gather_rows(torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(dev), mesh)
    return out.cpu().numpy().astype(arr.dtype, copy=False)


def broadcast_str(value: str, max_len: int = 256) -> str:
    """``value`` as process 0 has it, on every process (the run directory's
    timestamped name: every process must write under one path)."""
    if process_count() == 1:
        return value
    buf = np.zeros(max_len, np.uint8)
    raw = value.encode()[:max_len]
    buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    t = torch.from_numpy(buf).to(_collective_device())
    dist.broadcast(t, src=0)
    out = t.cpu().numpy()
    return bytes(out[out > 0]).decode()


def barrier() -> None:
    """Wait for every process (after process 0 writes a file the others
    read); nothing with one process."""
    if process_count() > 1:
        dist.barrier()
