"""Tracing, experiment logging and statistical runners (counterpart of
``applecider_tpu/utils/observability.py``).

* ``grad_norm`` and ``PruningHook``: the training loop's gradient norm and
  optuna trial pruning;
* ``ExperimentLogger``: one JSON line per record in ``<log_dir>/events.jsonl``,
  and to wandb as well where a project is named and wandb imports;
* ``multi_seed_run``: a run per seed, each scalar's mean, std and values;
* ``profile_trace``: a ``torch.profiler`` scope over the CPU and, where a
  card is present, the card, that writes a Chrome trace
  (``<log_dir>/trace.json``, for chrome://tracing or Perfetto) when it
  closes; the JAX package's scope writes a ``jax.profiler`` trace instead.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch


def grad_norm(grads: Iterable[torch.Tensor | None]) -> torch.Tensor:
    """Global L2 norm of the gradients, sqrt of the sum of squares over all
    of them in f32 (``None``, a parameter without a gradient, adds 0)."""
    grads = [g.float() for g in grads if g is not None]
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class PruningHook:
    """Optuna-style pruning hook; inert when no trial is attached."""

    def __init__(self, trial=None):
        self.trial = trial

    def report_and_maybe_prune(self, value: float, step: int) -> bool:
        """Returns True if the run should stop early."""
        if self.trial is None:
            return False
        self.trial.report(value, step)
        if self.trial.should_prune():
            try:
                import optuna

                raise optuna.TrialPruned()
            except ImportError:
                return True
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str | Path, enabled: bool = True):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<log_dir>/trace.json``; yields the profiler (None when not
    ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _jsonable(v):
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return float(v) if np.size(v) == 1 else np.asarray(v.detach().cpu() if isinstance(
            v, torch.Tensor) else v).tolist()
    return v


class ExperimentLogger:
    """JSONL logger, with wandb beside it where ``wandb_project`` is given
    and wandb imports (it is not a dependency of the port)."""

    def __init__(self, log_dir: str | Path, wandb_project: str | None = None,
                 config: dict | None = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = self.log_dir / "events.jsonl"
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError:
                print("[logger] wandb not installed; JSONL only")
            else:
                self._wandb = wandb.init(project=wandb_project, config=config or {})

    def log(self, record: dict, step: int | None = None) -> None:
        """Append ``record`` (tensors and NumPy scalars as numbers or lists)
        with ``step`` when given."""
        payload = {k: _jsonable(v) for k, v in record.items()}
        if step is not None:
            payload["step"] = step
        with open(self._file, "a") as f:
            f.write(json.dumps(payload, default=str) + "\n")
        if self._wandb is not None:
            self._wandb.log(payload, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def multi_seed_run(run_fn: Callable[[int], dict], seeds: Iterable[int]) -> dict:
    """``run_fn(seed)`` for each seed; ``summary`` holds each scalar
    metric's mean, population std and values over the runs that report it."""
    results = [run_fn(int(seed)) for seed in seeds]
    keys = sorted({k for r in results for k, v in r.items()
                   if isinstance(v, (int, float, np.floating))})
    summary = {}
    for k in keys:
        vals = np.asarray([float(r[k]) for r in results if k in r])
        summary[k] = {"mean": float(vals.mean()), "std": float(vals.std()), "values": vals.tolist()}
    return {"per_seed": results, "summary": summary}
