"""Training loop of any ``Task`` (counterpart of
``applecider_tpu/train/trainer.py`` for one process).

``Trainer.train_step`` does what the JAX package's jitted step does: the
task's forward and loss in training mode with every dropout site live, the
backward, and the optimizer built as the JAX Trainer composes it
(``train/optim.py``): with ``train.freeze_params`` only the parameters
outside the frozen subtrees are the optimizer's (every gradient is still
computed, so the attention keeps K4 and its dropout), with
``train.grad_accum_steps`` k the optimizer steps on every k-th microbatch
with the mean gradient, the clip (``task.grad_clip``, optax's rule) sees
the trainable gradients, and ``train.plateau_factor`` scales the learning
rates. ``train.ema_decay`` keeps a shadow of the parameters, updated after
every microbatch. The metrics are the task's plus ``grad_norm``, the norm
of all gradients before clipping. On the card the photometry attention runs
on kernel K4 forward and backward, and every SpectraNet LN+GELU on K3
forward and backward. Parameters stay f32; in bf16 compute each layer casts
them where it uses them.

``fit`` runs epochs over a ``DataLoader``, from ``init_params`` (a
``state_dict``) if given, evaluates on a validation loader if one is given
(on the EMA shadow when ``train.eval_with_ema``, the default), stops early
on the validation loss, steps the plateau tracker on it, keeps the best
checkpoint by validation accuracy (by -loss for a task without logits),
holding the weights that were validated, appends one record per epoch to
``metrics.jsonl`` and checkpoints ``{params, opt_state, step, epoch}`` (and
``ema``, ``plateau``, ``grad_accum`` when on) with ``torch.save``; a later
``fit`` resumes from ``last`` at the next epoch, which wins over
``init_params``. ``evaluate`` returns the scalars of
``ops.metrics.classification_report`` and the loss.

``predict`` runs a loader through ``task.predict`` without autograd, in
dataset order; ``restore_weights`` loads the weights of ``best``, or of
``last`` where there is no ``best``, for inference.

The JAX Trainer's options that the port has not yet (ROADMAP.md Queue A
item 2 for ``train.remat``, item 7 for the parallel ones) raise when a
config sets them away from their defaults (``refuse_unported``); none is
ignored.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task
from applecider_tpu_torch.ops.dropout import DropoutRNG, attach_dropout_rng
from applecider_tpu_torch.ops.metrics import classification_report
from applecider_tpu_torch.train.optim import (
    EMA, EarlyStopping, GradAccumulator, ReduceLROnPlateau, clip_by_global_norm_, set_lr_scale,
    swapped_weights, trainable_parameters,
)
from applecider_tpu_torch.utils.observability import grad_norm

_REMAT_ITEM = ("ROADMAP.md Queue A item 2 (train.remat: a replayed forward would draw new "
               "dropout seeds)")
_PARALLEL_ITEM = "ROADMAP.md Queue A item 7 (multi-GPU and multi-host)"


def refuse_unported(cfg: Config) -> None:
    """Raise for each option the JAX Trainer has and the port has not yet,
    when ``cfg`` sets it away from its default, naming the option and its
    ROADMAP item."""
    unported = [
        ("train.remat", bool(cfg.get_path("train.remat", False)), _REMAT_ITEM),
        ("parallel.multihost.enable", bool(cfg.get_path("parallel.multihost.enable", False)),
         _PARALLEL_ITEM),
        ("parallel.mesh_shape", list(cfg.get_path("parallel.mesh_shape", [-1, 1])) != [-1, 1],
         _PARALLEL_ITEM),
    ]
    for name, is_set, item in unported:
        if is_set:
            raise NotImplementedError(
                f"{name} = {cfg.get_path(name)!r} is not ported to applecider_tpu_torch yet "
                f"({item}); leave it at its default")


class Trainer:
    def __init__(self, task: Task, cfg: Config, workdir: str | Path, device="cuda",
                 seed: int | None = None):
        refuse_unported(cfg)
        self.task = task
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = task.module.to(self.device).train().requires_grad_(True)
        self.seed = int(cfg.get_path("train.seed", 42) if seed is None else seed)
        self.rng = DropoutRNG(self.seed, self.device)
        attach_dropout_rng(self.model, self.rng)
        self.trainable = [p for _, p in trainable_parameters(
            self.model, cfg.get_path("train.freeze_params", []))]
        self.optimizer = task.make_optimizer(self.trainable)
        self._base_lrs = [g["lr"] for g in self.optimizer.param_groups]
        accum = int(cfg.get_path("train.grad_accum_steps", 1))
        self.accum = GradAccumulator(accum) if accum > 1 else None
        factor = float(cfg.get_path("train.plateau_factor", 0.0))
        self.plateau = None
        if factor > 0.0:
            self.plateau = ReduceLROnPlateau(
                factor=factor, patience=int(cfg.get_path("train.plateau_patience", 5)),
                min_scale=float(cfg.get_path("train.plateau_min_scale", 1e-3)))
        decay = float(cfg.get_path("train.ema_decay", 0.0))
        self.ema = EMA(decay) if decay > 0 else None
        self.step = 0
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._log_file = self.workdir / "metrics.jsonl"

    # ------------------------------------------------------------ the step
    def to_device(self, arrays) -> tuple[torch.Tensor, ...]:
        """``to_tensor``'s NumPy arrays as tensors on the trainer's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def apply_gradients(self) -> torch.Tensor | None:
        """Fold the trainable parameters' gradients into the accumulated
        mean, if accumulating; on a microbatch that emits (every one when
        not), clip them by their global norm and take one optimizer step.
        Returns the norm the clip saw, or None on a microbatch that only
        accumulates."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.trainable]
        if self.accum is not None:
            grads = self.accum.add(grads)
            if grads is None:
                return None
            for p, g in zip(self.trainable, grads):
                p.grad = g
        if (self.task.grad_clip or 0.0) > 0.0:
            norm = clip_by_global_norm_(grads, self.task.grad_clip)
        else:
            norm = grad_norm(grads)
        self.optimizer.step()
        return norm

    def train_step(self, batch, kernels: bool = True) -> dict[str, torch.Tensor]:
        """One microbatch on ``batch`` (device tensors from ``to_device``);
        metrics stay on the device."""
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.task.loss(batch, train=True, kernels=kernels)
        loss.backward()
        norm = grad_norm(p.grad for p in self.model.parameters())
        self.apply_gradients()
        self.step += 1
        if self.ema is not None:
            self.ema.update(self.model)
        metrics = {k: v.detach() for k, v in aux["metrics"].items()}
        metrics["grad_norm"] = norm
        return metrics

    @torch.no_grad()
    def evaluate(self, loader) -> dict[str, float]:
        """The loss (the mean over batches, weighted by their sizes) and,
        for a task with logits, the scalars of ``classification_report`` of
        their softmax, over ``loader``, in eval mode without autograd."""
        probs, labels, losses, sizes = [], [], [], []
        for host_batch in loader:
            arrays = self.task.to_tensor(host_batch)
            loss, aux = self.task.loss(self.to_device(arrays), train=False)
            raw_labels = np.asarray(arrays[-1])
            losses.append(float(loss))
            sizes.append(len(raw_labels))
            if aux.get("logits") is not None:
                probs.append(torch.softmax(aux["logits"].float(), dim=-1).cpu().numpy())
            labels.append(raw_labels.argmax(-1) if raw_labels.ndim > 1 else raw_labels)
        mean_loss = float(np.average(np.asarray(losses), weights=np.asarray(sizes, np.float64)))
        if not probs:  # pretraining tasks expose no logits
            return {"loss": mean_loss}
        report = classification_report(np.concatenate(probs), np.concatenate(labels))
        report = {k: v for k, v in report.items() if not isinstance(v, (dict, np.ndarray))}
        report["loss"] = mean_loss
        return report

    # ---------------------------------------------------------- checkpoints
    def _ckpt_path(self, tag: str) -> Path:
        return self.workdir / "checkpoints" / f"{tag}.pt"

    def save_checkpoint(self, epoch: int, tag: str = "last", params=None) -> None:
        """``params`` (parameters by name) are stored in place of the model's
        parameters: the best checkpoint holds the EMA shadow it was
        validated on, beside the model's buffers (TriPool's frozen
        BatchNorm statistics)."""
        path = self._ckpt_path(tag)
        path.parent.mkdir(parents=True, exist_ok=True)
        state = {"params": {**self.model.state_dict(), **(params or {})},
                 "opt_state": self.optimizer.state_dict(), "step": self.step,
                 "epoch": int(epoch)}
        if self.ema is not None and self.ema.shadow is not None:
            state["ema"] = self.ema.shadow
        if self.plateau is not None:
            state["plateau"] = [self.plateau.best, self.plateau.bad_epochs, self.plateau.scale]
        if self.accum is not None:
            state["grad_accum"] = self.accum.state_dict()
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state, tmp)
        tmp.replace(path)

    def restore_checkpoint(self, tag: str = "last") -> int:
        """Load ``tag`` if it exists; returns the epoch to start from. A
        checkpoint without ``ema``, ``plateau`` or ``grad_accum`` leaves
        that state fresh."""
        path = self._ckpt_path(tag)
        if not path.exists():
            return 0
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        if self.ema is not None and "ema" in state:
            self.ema.shadow = state["ema"]
        if self.plateau is not None and "plateau" in state:
            best, bad, scale = state["plateau"]
            self.plateau.best, self.plateau.bad_epochs, self.plateau.scale = \
                float(best), int(bad), float(scale)
        if self.plateau is not None:
            set_lr_scale(self.optimizer, self._base_lrs, self.plateau.scale)
        if self.accum is not None and "grad_accum" in state:
            self.accum.load_state_dict(state["grad_accum"])
        return int(state["epoch"]) + 1

    def restore_weights(self) -> str:
        """Load the weights of ``best``, or of ``last`` where there is no
        ``best``, for inference; returns the tag loaded."""
        tag = "best" if self._ckpt_path("best").exists() else "last"
        path = self._ckpt_path(tag)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint under {path.parent}")
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        return tag

    @torch.no_grad()
    def predict(self, loader, kernels: bool = True) -> np.ndarray:
        """``task.predict`` (logits, or probabilities where the task's
        ``use_probabilities`` is set) for every sample ``loader`` yields, in
        its order, as float32, without autograd."""
        out = [self.task.predict(self.to_device(self.task.to_tensor(b)), kernels=kernels)
               for b in loader]
        return torch.cat(out).float().cpu().numpy()

    def _log(self, record: dict) -> None:
        with open(self._log_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------ fit
    def fit(self, train_loader, val_loader=None, epochs: int | None = None, pruning_hook=None,
            init_params: dict[str, torch.Tensor] | None = None) -> dict:
        """``init_params``: start from these weights (a state_dict, e.g.
        ``models.mpt.warmstart_classifier_params``) instead of the task's
        own; a checkpoint resume wins over it. ``pruning_hook``:
        ``report_and_maybe_prune(val_loss, epoch)`` after each validation,
        True stopping the run."""
        cfg = self.cfg
        epochs = int(epochs or cfg.get_path("train.epochs", 10))
        stopper = EarlyStopping(int(cfg.get_path("train.early_stop_patience", 30)))
        if init_params is not None:
            self.model.load_state_dict(init_params)
        start_epoch = 0
        if bool(cfg.get_path("checkpoint.resume", True)):
            start_epoch = self.restore_checkpoint("last")
        if self.ema is not None and self.ema.shadow is None:  # a resumed shadow stays
            self.ema.init(self.model)
        ema_eval = self.ema is not None and bool(cfg.get_path("train.eval_with_ema", True))
        every = int(cfg.get_path("checkpoint.save_every_epochs", 1))
        best_metric = -np.inf
        history = []
        last_epoch = start_epoch - 1
        for epoch in range(start_epoch, epochs):
            last_epoch = epoch
            train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            losses, metrics = [], {}
            for host_batch in train_loader:
                metrics = self.train_step(self.to_device(self.task.to_tensor(host_batch)))
                losses.append(metrics["loss"])
            record = {"epoch": epoch,
                      "train_loss": float(torch.stack(losses).mean()) if losses else float("nan"),
                      "steps": self.step, "epoch_seconds": time.perf_counter() - t0}
            if losses:
                record["last_grad_norm"] = float(metrics["grad_norm"])
            should_stop = False
            if val_loader is not None:
                if ema_eval:
                    with swapped_weights(self.model, self.ema.shadow):
                        val = self.evaluate(val_loader)
                else:
                    val = self.evaluate(val_loader)
                record.update({f"val_{k}": v for k, v in val.items()})
                monitor = val.get("accuracy", -val["loss"])
                if monitor > best_metric:
                    best_metric = monitor
                    self.save_checkpoint(epoch, "best", self.ema.shadow if ema_eval else None)
                should_stop = stopper.step(val["loss"])
                if self.plateau is not None:
                    scale = self.plateau.step(val["loss"])
                    set_lr_scale(self.optimizer, self._base_lrs, scale)
                    record["lr_scale"] = scale
                if pruning_hook is not None and pruning_hook.report_and_maybe_prune(
                        val["loss"], epoch):
                    should_stop = True
            self._log(record)
            history.append(record)
            if epoch % every == 0:
                self.save_checkpoint(epoch, "last")
            if should_stop:
                break
        # the epoch actually reached: after an early stop a resume with a
        # larger budget must not skip the epochs that never ran
        self.save_checkpoint(last_epoch, "last")
        return {"history": history, "best_metric": best_metric}
