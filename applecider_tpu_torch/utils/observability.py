"""The training loop's gradient norm and trial-pruning hook (the pieces of
``applecider_tpu/utils/observability.py`` that ``Trainer.fit`` uses)."""

from __future__ import annotations

from typing import Iterable

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
