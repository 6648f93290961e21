"""Training loop of the AppleCider fusion model (counterpart of
``applecider_tpu/train/trainer.py`` for one process).

``Trainer.train_step`` does what the JAX package's jitted step does: the
forward in training mode with every dropout site live, the task's loss
(cross entropy, or focal loss), the backward, ``clip_by_global_norm`` with
optax's rule, an Adam update, and the metrics ``loss``, ``accuracy`` and
``grad_norm`` (of the gradients before clipping). On the card the
photometry attention runs on kernel K4 forward and backward, and every
SpectraNet LN+GELU on K3 forward and backward. Parameters stay f32; in
bf16 compute each layer casts them where it uses them, and autograd carries
the gradient back through that cast.

``fit`` runs epochs over a ``DataLoader``, keeps the metrics on the device
until the epoch ends, evaluates on a validation loader if one is given,
stops early on the validation loss, keeps the best checkpoint by validation
accuracy, appends one record per epoch to ``metrics.jsonl`` and checkpoints
``{params, opt_state, step, epoch}`` with ``torch.save``; a later ``fit``
resumes from ``last`` at the next epoch.

``predict`` runs a loader in eval mode without autograd and returns the
logits (or, with ``model.AppleCider.use_probabilities``, the softmax) in
dataset order; ``restore_weights`` loads the weights of ``best``, or of
``last`` where there is no ``best``, for inference.

The JAX Trainer's options that the port has not yet (ROADMAP.md Queue A
item 2 for the trainer's, item 7 for the parallel ones) raise when a config
sets them away from their defaults (``refuse_unported``); none is ignored.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.fusion import fusion_loss, to_tensor
from applecider_tpu_torch.ops.dropout import DropoutRNG, attach_dropout_rng
from applecider_tpu_torch.train.optim import EarlyStopping, clip_by_global_norm_, make_optimizer


_TRAINER_ITEM = "ROADMAP.md Queue A item 2 (trainer options)"
_PARALLEL_ITEM = "ROADMAP.md Queue A item 7 (multi-GPU and multi-host)"


def refuse_unported(cfg: Config) -> None:
    """Raise for each option the JAX Trainer has and the port has not yet,
    when ``cfg`` sets it away from its default, naming the option and its
    ROADMAP item."""
    unported = [
        ("train.freeze_params", bool(cfg.get_path("train.freeze_params", [])), _TRAINER_ITEM),
        ("train.grad_accum_steps", int(cfg.get_path("train.grad_accum_steps", 1)) > 1,
         _TRAINER_ITEM),
        ("train.plateau_factor", float(cfg.get_path("train.plateau_factor", 0.0)) > 0,
         _TRAINER_ITEM),
        ("train.ema_decay", float(cfg.get_path("train.ema_decay", 0.0)) > 0, _TRAINER_ITEM),
        ("train.remat", bool(cfg.get_path("train.remat", False)), _TRAINER_ITEM),
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
    def __init__(self, model: nn.Module, cfg: Config, workdir: str | Path, device="cuda",
                 seed: int | None = None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device).train().requires_grad_(True)
        fc = cfg["model"]["AppleCider"]
        self.grad_clip = float(fc.get("grad_clip", 1.0))
        self.optimizer = make_optimizer(self.model.parameters(), float(fc.get("lr", 1e-4)))
        self.seed = int(cfg.get_path("train.seed", 42) if seed is None else seed)
        self.rng = DropoutRNG(self.seed, self.device)
        attach_dropout_rng(self.model, self.rng)
        self.step = 0
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._log_file = self.workdir / "metrics.jsonl"

    # ------------------------------------------------------------ the step
    def to_device(self, arrays) -> tuple[torch.Tensor, ...]:
        """``to_tensor``'s NumPy arrays as tensors on the trainer's device."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in arrays)

    def loss_and_accuracy(self, batch, kernels: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """Forward of ``batch`` (device tensors from ``to_device``) and the
        task's loss and accuracy."""
        photometry, photo_mask, metadata, images, spectra, labels = batch
        logits = self.model(photometry, photo_mask, metadata, images, spectra, kernels=kernels)
        return fusion_loss(logits, labels, self.cfg)

    def apply_gradients(self) -> torch.Tensor:
        """Clip the gradients by their global norm and take one Adam step;
        returns the norm before clipping."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.grad_clip)
        self.optimizer.step()
        return norm

    def train_step(self, batch, kernels: bool = True) -> dict[str, torch.Tensor]:
        """One optimizer step on ``batch``; metrics stay on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, acc = self.loss_and_accuracy(batch, kernels)
        loss.backward()
        norm = self.apply_gradients()
        self.step += 1
        return {"loss": loss.detach(), "accuracy": acc, "grad_norm": norm}

    @torch.no_grad()
    def evaluate(self, loader) -> dict[str, float]:
        """Loss (the mean over batches, weighted by their sizes) and accuracy
        over ``loader``, in eval mode without autograd."""
        self.model.eval()
        losses, correct, sizes = [], [], []
        for host_batch in loader:
            batch = self.to_device(to_tensor(host_batch))
            loss, acc = self.loss_and_accuracy(batch)
            n = batch[-1].shape[0]
            losses.append(loss * n)
            correct.append(acc * n)
            sizes.append(n)
        self.model.train()
        total = float(sum(sizes))
        return {"loss": float(torch.stack(losses).sum()) / total,
                "accuracy": float(torch.stack(correct).sum()) / total}

    # ---------------------------------------------------------- checkpoints
    def _ckpt_path(self, tag: str) -> Path:
        return self.workdir / "checkpoints" / f"{tag}.pt"

    def save_checkpoint(self, epoch: int, tag: str = "last") -> None:
        path = self._ckpt_path(tag)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        torch.save({"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                    "step": self.step, "epoch": int(epoch)}, tmp)
        tmp.replace(path)

    def restore_checkpoint(self, tag: str = "last") -> int:
        """Load ``tag`` if it exists; returns the epoch to start from."""
        path = self._ckpt_path(tag)
        if not path.exists():
            return 0
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
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
        """(N, C) float32 logits, or probabilities when
        ``model.AppleCider.use_probabilities`` is set, for every sample
        ``loader`` yields, in its order, in eval mode without autograd."""
        probs = bool(self.cfg.get_path("model.AppleCider.use_probabilities", False))
        self.model.eval()
        out = []
        for host_batch in loader:
            photometry, photo_mask, metadata, images, spectra, _ = self.to_device(
                to_tensor(host_batch))
            logits = self.model(photometry, photo_mask, metadata, images, spectra,
                                kernels=kernels)
            out.append(torch.softmax(logits.float(), dim=-1) if probs else logits)
        self.model.train()
        if not out:
            return np.zeros((0, self.model.num_classes), np.float32)
        return torch.cat(out).float().cpu().numpy()

    def _log(self, record: dict) -> None:
        with open(self._log_file, "a") as f:
            f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------ fit
    def fit(self, train_loader, val_loader=None, epochs: int | None = None) -> dict:
        cfg = self.cfg
        epochs = int(epochs or cfg.get_path("train.epochs", 10))
        stopper = EarlyStopping(int(cfg.get_path("train.early_stop_patience", 30)))
        start_epoch = 0
        if bool(cfg.get_path("checkpoint.resume", True)):
            start_epoch = self.restore_checkpoint("last")
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
                metrics = self.train_step(self.to_device(to_tensor(host_batch)))
                losses.append(metrics["loss"])
            record = {"epoch": epoch,
                      "train_loss": float(torch.stack(losses).mean()) if losses else float("nan"),
                      "steps": self.step, "epoch_seconds": time.perf_counter() - t0}
            if losses:
                record["last_grad_norm"] = float(metrics["grad_norm"])
            should_stop = False
            if val_loader is not None:
                val = self.evaluate(val_loader)
                record.update({f"val_{k}": v for k, v in val.items()})
                if val["accuracy"] > best_metric:
                    best_metric = val["accuracy"]
                    self.save_checkpoint(epoch, "best")
                should_stop = stopper.step(val["loss"])
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
