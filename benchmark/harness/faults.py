"""Faults planted under the program for the check's own tests and for the
readings that set its limits: each breaks the timed path the way a wrong
optimisation could, and the check has to read it as not correct."""

from __future__ import annotations

import torch


def answer_altered(runner) -> None:
    """Every served answer altered where it is produced: the first two
    classes' probabilities swapped in the program's output."""
    program = runner.router.pipe.program
    forward = program.forward

    def altered(raw):
        p = forward(raw)
        return p[:, [1, 0] + list(range(2, p.shape[1]))]

    program.forward = altered


def half_batch_served(runner) -> None:
    """Half of each served batch left out: its rows come back as zeros."""
    program = runner.router.pipe.program
    forward = program.forward

    def half(raw):
        p = forward(raw)
        return torch.cat([p[: p.shape[0] // 2], torch.zeros_like(p[p.shape[0] // 2:])])

    program.forward = half


def state_unchanged(runner) -> None:
    """A training step that returns its state unchanged: the optimizer's
    step does nothing."""
    runner.trainer.optimizer.step = lambda *a, **k: None


def half_batch_trained(runner) -> None:
    """Half of each training batch left out, the loss's mean taken over the
    rest."""
    task = runner.task
    loss = task.loss

    def half(batch, **kw):
        n = batch[0].shape[0] // 2
        return loss(tuple(t[:n] if t.dim() and t.shape[0] == 2 * n else t for t in batch), **kw)

    task.loss = half


SERVE = {"answer_altered": answer_altered, "half_batch": half_batch_served}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch_trained}
FAULTS = {"alert_stream": SERVE, "train_steps": TRAIN}
