"""Run the ranks of a job as spawned processes of this host.

``spawn(fn, world, *args)`` starts ``world`` processes, each calling
``fn(rank, world, *args)``, and returns their results in rank order. ``fn``
starts the process group itself (``multihost.maybe_initialize`` from its
config); a group left open is destroyed when the rank returns. A rank that
raises fails the call with its traceback, and ranks still running after
``timeout_s`` are killed and fail it too, so a rank that waits forever on a
peer cannot hang the caller. ``fn`` must be importable by name (a function
of a module, or of the main script under an ``if __name__ == "__main__"``
guard), and its result picklable.
"""

from __future__ import annotations

import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn, world: int, args: tuple, out: Path) -> None:
    try:
        torch.save(fn(rank, world, *args), out / f"{rank}.pt")
    except BaseException:
        (out / f"{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, timeout_s: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes; their
    results in rank order."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        out = Path(tmp)
        ctx = mp.start_processes(_rank_main, args=(fn, world, args, out), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"ranks still running after {timeout_s} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errors = [p.read_text() for p in sorted(out.glob("*.err"))]
            raise RuntimeError("a rank failed:\n" + "\n".join(errors or [str(e)])) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
        # written by the ranks of this call
        return [torch.load(out / f"{r}.pt", weights_only=False) for r in range(world)]
