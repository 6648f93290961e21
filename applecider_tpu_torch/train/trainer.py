"""Training loop of any ``Task`` (counterpart of
``applecider_tpu/train/trainer.py``).

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
every microbatch. ``train.remat`` computes the task's loss under an
activation checkpoint (``ops.dropout.checkpoint``, the JAX step's
``jax.checkpoint(loss_fn)``): the backward recomputes the forward, drawing
the same dropout bits, K4 seeds and MPT mask again, so the step equals the
plain one; a module that moves a buffer in that forward raises, because the
recompute would move it twice. The metrics are the task's plus
``grad_norm``, the norm of all gradients before clipping. On the card the photometry attention runs
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

Data parallel (``parallel/``): the Trainer starts the process group from
``parallel.multihost`` and lays its ranks out as ``parallel.mesh_shape``
over ``parallel.mesh_axes``. Each rank takes its shard of every loader
(``DataLoader(num_shards=, shard_index=)`` by its data index) and a
replica of the weights, broadcast from rank 0. After the backward the
gradient is all-reduced over the data axis as a mean, so the clip,
``grad_norm``, accumulation, freeze, plateau, EMA and remat all see the
global batch's gradient on every rank; the floating metrics are averaged
and the integer ones (counts) summed. A loss that is not a plain mean over
rows reduces its sums across the data axis itself (MPT's masked mean, the
zoo's train-mode BatchNorm; ``parallel.mesh.data_sum``, given to every
submodule with a ``mesh`` attribute). Each data rank draws its own dropout
bits, K4 seeds and MPT mask (``DropoutRNG(stream=)``). ``evaluate`` and
``predict`` gather their rows across the data axis, so every rank takes
the same decisions and returns every row; rank 0 alone writes the
checkpoints and ``metrics.jsonl``, and every rank reads them. With no
process group every one of these hooks is a no-op.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from applecider_tpu_torch.config import Config
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task
from applecider_tpu_torch.ops.dropout import DropoutRNG, attach_dropout_rng, checkpoint
from applecider_tpu_torch.ops.metrics import classification_report
from applecider_tpu_torch.parallel.mesh import Mesh, gather_rows, make_mesh, replicate
from applecider_tpu_torch.parallel.multihost import (
    allgather_host_rows, barrier, host_local_batch_to_global, local_rows, maybe_initialize,
)
from applecider_tpu_torch.train.optim import (
    EMA, EarlyStopping, GradAccumulator, ReduceLROnPlateau, clip_by_global_norm_, set_lr_scale,
    swapped_weights, trainable_parameters,
)
from applecider_tpu_torch.utils.observability import grad_norm

def attach_mesh(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Every submodule with a ``mesh`` attribute reduces over ``mesh``."""
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh


class Trainer:
    def __init__(self, task: Task, cfg: Config, workdir: str | Path, device="cuda",
                 seed: int | None = None, mesh: Mesh | None = None):
        """``mesh``: the ranks' layout; by default ``parallel.mesh_shape``
        over ``parallel.mesh_axes`` of the process group that
        ``parallel.multihost`` starts (one rank without one)."""
        self.process_index, self.process_count = maybe_initialize(cfg, device)
        if mesh is None:
            mesh = make_mesh(shape=tuple(cfg.get_path("parallel.mesh_shape", [-1, 1])),
                             axes=tuple(cfg.get_path("parallel.mesh_axes", ["data", "model"])))
        self.mesh = mesh
        self.data_index = mesh.index("data")
        remat = cfg.get_path("train.remat", False)
        if not isinstance(remat, bool):
            raise ValueError(f"train.remat = {remat!r}: expected true or false")
        self.remat = remat
        self._buffers_checked = False
        self.task = task
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = task.module.to(self.device).train().requires_grad_(True)
        replicate(self.model, mesh)
        attach_mesh(self.model, mesh if mesh.reduces("data") else None)
        self.seed = int(cfg.get_path("train.seed", 42) if seed is None else seed)
        self.rng = DropoutRNG(self.seed, self.device, stream=self.data_index)
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

    def loss(self, batch, train: bool = True, kernels: bool = True):
        """``task.loss``; under ``train.remat`` inside the activation
        checkpoint, whose recompute replays every generator of the run."""
        if not (self.remat and torch.is_grad_enabled()):
            return self.task.loss(batch, train=train, kernels=kernels)
        # the first checkpointed forward is checked for buffers it moves
        # (a BatchNorm in training mode), which the recompute would move again
        buffers = [] if self._buffers_checked else [
            (n, b, b.clone()) for n, b in self.model.named_buffers()]
        out = checkpoint(lambda *b: self.task.loss(b, train=train, kernels=kernels), *batch,
                         rngs=[self.rng])
        moved = [n for n, b, before in buffers if not torch.equal(b, before)]
        if moved:
            raise RuntimeError(f"train.remat: the forward updated the buffers {moved}, which "
                               "the backward's recompute would update again")
        self._buffers_checked = True
        return out

    def reduce_gradients(self) -> None:
        """Every gradient replaced by its mean over the mesh's data axis, in
        one all-reduce of a flat buffer (a parameter without a gradient
        gets the mean of zeros and the others'); nothing without a process
        group."""
        if not self.mesh.reduces("data"):
            return
        params = [p for p in self.model.parameters() if p.requires_grad]
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat, group=self.mesh.group("data"))
        flat /= self.mesh.shape["data"]
        offset = 0
        for p in params:
            p.grad = flat[offset: offset + p.numel()].view_as(p)
            offset += p.numel()

    def reduce_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The step's metrics over the global batch: floating ones (batch
        means) averaged over the data axis, integer ones (counts) summed."""
        if not self.mesh.reduces("data"):
            return metrics
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        out = dict(metrics)
        for floating in (True, False):
            keys = [k for k, v in metrics.items() if v.is_floating_point() == floating]
            if not keys:
                continue
            stacked = torch.stack([metrics[k].to(torch.float32 if floating else torch.int64)
                                   for k in keys])
            dist.all_reduce(stacked, group=group)
            if floating:
                stacked /= n
            out.update({k: v.to(metrics[k].dtype) for k, v in zip(keys, stacked)})
        return out

    def train_step(self, batch, kernels: bool = True) -> dict[str, torch.Tensor]:
        """One microbatch on ``batch`` (device tensors from ``to_device``);
        metrics stay on the device."""
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, train=True, kernels=kernels)
        loss.backward()
        self.reduce_gradients()
        norm = grad_norm(p.grad for p in self.model.parameters())
        self.apply_gradients()
        self.step += 1
        if self.ema is not None:
            self.ema.update(self.model)
        metrics = self.reduce_metrics({k: v.detach() for k, v in aux["metrics"].items()})
        metrics["grad_norm"] = norm
        return metrics

    def _check_loader(self, loader) -> None:
        """A loader must be sharded over the mesh's data axis, as this rank's
        share: otherwise every rank would take the same rows."""
        n = self.mesh.shape["data"]
        shards = (int(getattr(loader, "num_shards", 1)), int(getattr(loader, "shard_index", 0)))
        if self.mesh.distributed and shards != (n, self.data_index):
            raise ValueError(
                f"the loader is shard {shards[1]} of {shards[0]}, but this rank is data index "
                f"{self.data_index} of {n}: build it with DataLoader(num_shards={n}, "
                f"shard_index={self.data_index})")

    def _local_arrays(self, host_batch) -> tuple:
        return host_local_batch_to_global(self.task.to_tensor(host_batch), self.mesh)

    @torch.no_grad()
    def evaluate(self, loader) -> dict[str, float]:
        """The loss (the mean over batches, weighted by their sizes) and,
        for a task with logits, the scalars of ``classification_report`` of
        their softmax, over ``loader``, in eval mode without autograd."""
        self._check_loader(loader)
        probs, labels, losses, sizes = [], [], [], []
        for host_batch in loader:
            arrays = self._local_arrays(host_batch)
            loss, aux = self.task.loss(self.to_device(arrays), train=False)
            raw_labels = np.asarray(arrays[-1])
            losses.append(float(loss))
            sizes.append(len(raw_labels))
            if aux.get("logits") is not None:
                probs.append(local_rows(torch.softmax(aux["logits"].float(), dim=-1),
                                        len(raw_labels)))
            labels.append(raw_labels.argmax(-1) if raw_labels.ndim > 1 else raw_labels)
        # the size-weighted mean over every rank's batches
        sizes = np.asarray(sizes, np.float64)
        sums = np.array([np.multiply(np.asarray(losses, np.float64), sizes).sum(), sizes.sum()])
        sums = allgather_host_rows(sums[None], self.mesh).sum(axis=0)
        mean_loss = float(sums[0] / sums[1])
        if not probs:  # pretraining tasks expose no logits
            return {"loss": mean_loss}
        report = classification_report(allgather_host_rows(np.concatenate(probs), self.mesh),
                                        allgather_host_rows(np.concatenate(labels), self.mesh))
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
        if self.process_index == 0:  # one writer; every rank reads
            tmp = path.with_name(path.name + ".tmp")
            torch.save(state, tmp)
            tmp.replace(path)
        barrier()

    def restore_checkpoint(self, tag: str = "last") -> int:
        """Load ``tag`` if it exists; returns the epoch to start from. A
        checkpoint without ``ema``, ``plateau`` or ``grad_accum`` leaves
        that state fresh, and one without ``opt_state`` (a JAX run carried
        over by ``scripts/convert_jax_checkpoint.py --params-only``) the
        optimizer."""
        path = self._ckpt_path(tag)
        if not path.exists():
            return 0
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["params"])
        if "opt_state" in state:
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
        its order, as float32, without autograd.

        Over a mesh every rank returns every row of the data set in dataset
        order: the shards' rows are gathered and put back through the
        loader's ``shard_emit_plan``, and the rows no shard emits (the
        common-length cut, drop_last) are predicted on every rank
        (``_predict_replicated``)."""
        self._check_loader(loader)
        plan = loader.shard_emit_plan() if self.mesh.distributed else None
        out = [self.task.predict(self.to_device(self.task.to_tensor(b)), kernels=kernels)
               for b in loader]
        if plan is None:
            return torch.cat(out).float().cpu().numpy()
        leftover = self._predict_replicated(loader.dataset, plan["leftover"], kernels)
        order = np.concatenate(plan["per_shard"])
        local = torch.cat(out).float() if out else torch.zeros(
            (0, *leftover.shape[1:]), device=self.device)
        rows = gather_rows(local, self.mesh).cpu().numpy()
        full = np.empty((order.size + leftover.shape[0], *rows.shape[1:]), np.float32)
        full[order] = rows
        if leftover.size:
            full[plan["leftover"]] = leftover
        return full

    def _predict_replicated(self, dataset, indices, kernels: bool = True) -> np.ndarray:
        """``task.predict`` of ``indices``, the same rows on every rank (no
        collective)."""
        idx = [int(i) for i in indices]
        if not idx:
            return np.zeros((0,), np.float32)
        batch = self.task.to_tensor(dataset.collate([dataset.sample(i) for i in idx]))
        return self.task.predict(self.to_device(batch), kernels=kernels).float().cpu().numpy()

    def _log(self, record: dict) -> None:
        if self.process_index == 0:  # every rank holds the same record
            with open(self._log_file, "a") as f:
                f.write(json.dumps(record) + "\n")
        barrier()

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
        self._check_loader(train_loader)
        for epoch in range(start_epoch, epochs):
            last_epoch = epoch
            train_loader.set_epoch(epoch)
            t0 = time.perf_counter()
            losses, metrics = [], {}
            for host_batch in train_loader:
                metrics = self.train_step(self.to_device(self._local_arrays(host_batch)))
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
