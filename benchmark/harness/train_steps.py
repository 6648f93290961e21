"""Runner of ``train_steps`` traffic: the program's ``Trainer`` stepping on
batches that its ``DataLoader`` (with its producer thread) assembles from
seeded samples, each step through ``Trainer.to_device`` and
``Trainer.train_step`` (loss, backward, clip and the optimizer), dropout
live.

Set-up builds one trainer and drives it through three checked steps and
two more warm-up steps; the window continues with that same trainer and
loader. The check runs the plain reference through the same three steps
from the same weights, batches and dropout draws.
"""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from benchmark.harness import common, spec, traffic, weights
from benchmark.reference import layers as ref_layers
from benchmark.reference.dropout import DropSource
from benchmark.reference.optim import AdamW, clip_by_global_norm

CHECKED_STEPS = 3
WARM_STEPS = 2
NEGLIGIBLE = 1e-3  # a leaf whose first gradient is under this share of the median's moves by rounding


class Runner:
    def __init__(self, cell: spec.Cell, device):
        self.cell, self.device = cell, torch.device(device)
        self.cfg = common.port_config(cell.config)
        self.ref = spec.reference(cell.config["name"])
        self.batch = int(cell.traffic["batch"])
        self.workdir = tempfile.TemporaryDirectory(prefix="portbench-")

    def roots(self) -> dict:
        return {"trainer": self.trainer, "task": self.task, "model": self.task.module}

    # ---------------------------------------------------------------- set-up
    def prepare(self, seed: int, fault=None) -> None:
        """Weights, samples, trainer and loader from ``seed``; the checked
        steps and the warm-up. ``fault(runner)``, if given, breaks the
        program before the first step."""
        from applecider_tpu_torch.datasets.loader import DataLoader
        from applecider_tpu_torch.train.trainer import Trainer

        self.seed = seed
        self.close_loader()
        s_weights, s_data, s_trainer, s_loader, _ = common.seeds(seed)
        self.trainer_seed = s_trainer
        self.task = common.build_task(self.cfg, self.device)
        model = self.task.module
        weights.load(model, weights.make_state(weights.shapes_of(model), s_weights, self.device))
        self.trainer = Trainer(self.task, self.cfg, self.workdir.name, device=self.device,
                               seed=s_trainer)
        self.data = traffic.training_samples(self.cell.traffic, s_data)
        self.loader = DataLoader(self.data, batch_size=self.batch, shuffle=True, seed=s_loader,
                                 drop_last=True, prefetch=2)
        self.it = iter(self.loader)
        if fault is not None:
            fault(self)
        names = [n for n, _ in model.named_parameters()]
        self.indices, losses = [], []
        for t in range(CHECKED_STEPS):
            hb, metrics = self.step()
            self.indices.append(np.asarray(hb["data"]["index"]))
            losses.append(metrics["loss"].detach().float())
            if t == 0:
                opt = self.trainer.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                state = [opt.state.get(p, {}).get("exp_avg") for _, p in model.named_parameters()]
                self.first_grad = {n: 0.0 if s is None else float(s.norm()) / (1.0 - beta1)
                                   for n, s in zip(names, state)}
        start = weights.make_state(weights.shapes_of(model), s_weights, self.device)
        self.change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
        del start
        self.losses = [float(x) for x in losses]
        for _ in range(WARM_STEPS):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def next_batch(self):
        """The loader's next batch; at an epoch's end the next epoch, as
        ``Trainer.fit`` iterates the loader again."""
        try:
            return next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            return next(self.it)

    def step(self):
        hb = self.next_batch()
        metrics = self.trainer.train_step(self.trainer.to_device(self.task.to_tensor(hb)))
        return hb, metrics

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, tick=None) -> dict:
        """Train for ``seconds``; ``tick()``, if given, is called after each
        step (the traced run's profiler stops in it)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        waits, seen = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            tw = time.perf_counter()
            hb = self.next_batch()
            waits.append(time.perf_counter() - tw)
            self.trainer.train_step(self.trainer.to_device(self.task.to_tensor(hb)))
            seen.append(hb["data"]["index"])
            if tick is not None:
                tick()
        if cuda:
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        n = len(seen) * self.batch
        points = [self.data.points(i) for idx in seen for i in idx]
        counts = np.unique(points, return_counts=True)
        flops = sum(3 * c * self.ref.forward_flops(self.cell.config, int(p), True)
                    for p, c in zip(*counts))
        return {
            "attempted": n, "failed": 0, "window_s": t1 - t0, "steps": len(seen),
            "e2e": {"train_samples_per_s": n / (t1 - t0), "train_peak_gib": peak / 2**30},
            "work": {"flops": float(flops), "items": n},
            "loop": {"loader_wait_s": waits},
        }

    def close_loader(self) -> None:
        """Stop the loader's producer thread, if one runs."""
        if getattr(self, "it", None) is not None:
            self.it.close()
        self.it = None

    def release(self) -> None:
        self.close_loader()
        self.loader = self.trainer = self.task = None
        common.free(self.device)
        self.workdir.cleanup()

    # ----------------------------------------------------------------- check
    def reference_steps(self, prec: str = "f32") -> dict:
        """The reference through the checked steps, from the same weights,
        batches and dropout draws: each step's loss, each leaf's norm of the
        first (clipped) gradient and of the change after the steps."""
        model = self.ref.build(self.cell.config).to(self.device)
        model.load_state_dict(weights.make_state(weights.shapes_of(model),
                                                 common.seeds(self.seed)[0], self.device))
        model.configure(ref_layers.Precision(prec), DropSource(self.trainer_seed, self.device))
        model.train()
        params = dict(model.named_parameters())
        start = {n: p.detach().clone() for n, p in params.items()}
        o = self.ref.optimizer(self.cell.config)
        opt = AdamW(o["lr"], weight_decay=o["weight_decay"])
        losses, first = [], {}
        with ref_layers.no_tf32():
            for t, idx in enumerate(self.indices):
                batch = self.ref.train_batch([self.data.sample(int(i)) for i in idx],
                                             self.data.max_len, self.device)
                loss = self.ref.loss(model, batch)
                grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
                grads = clip_by_global_norm(grads, o["grad_clip"])
                if t == 0:
                    first = {n: float(g.norm()) for n, g in grads.items()}
                opt.step(params, grads)
                losses.append(loss.item())
        change = {n: float((p.detach() - start[n]).norm()) for n, p in params.items()}
        del model, params, start, opt
        common.free(self.device)
        return {"losses": losses, "first_grad": first, "change": change}

    def readings(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}

    def check(self) -> dict:
        return self.compared(self.readings())

    def control(self, seconds: float = 0.0, name: str = "fp8") -> dict:
        """The check's numbers with the reference in float8 put in the
        program's place (no window: the steps are set-up's)."""
        if name != "fp8":
            raise ValueError(f"control {name!r}: expected fp8")
        return self.compared(self.reference_steps("fp8"))

    def compared(self, got: dict) -> dict:
        """``got``'s numbers against the float32 reference, and the ``*_rel``
        numbers: the median leaf's gaps over those of the reference's own
        products rounded to bfloat16, so that how sensitive the seed's
        weights and batches are cancels."""
        want, rounded = self.reference_steps("f32"), self.reference_steps("bf16")
        self.detail = {"got": got, "want": want, "bf16": rounded}
        out, base = compare(got, want), compare(rounded, want)
        for k in ("grad_gap", "update_gap"):
            out[k + "_rel"] = out[k + "_median"] / max(base[k + "_median"], 1e-12)
        return out


def compare(got: dict, want: dict) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss;
    ``loss_gap_first``: the first step's, where both sides start from the
    same weights, so that the later steps' drift does not swing it. Per
    leaf, the gap between the two norms of the first gradient, and of the
    change after the checked steps, over the reference's norm of that leaf
    or of the median leaf, whichever is larger: ``grad_gap`` and ``update_gap``
    take the worst leaf, ``*_median`` the median leaf. The change leaves
    out the leaves whose first gradient is negligible (``NEGLIGIBLE``) in
    the reference."""
    first = want["first_grad"]
    med = float(np.median(list(first.values())))
    moving = [n for n in first if first[n] >= NEGLIGIBLE * med]
    grads = leaf_gaps(got["first_grad"], first, list(first))
    changes = leaf_gaps(got["change"], want["change"], moving)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
        "loss_gap_first": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0]),
        "grad_gap": float(grads.max()), "grad_gap_median": float(np.median(grads)),
        "update_gap": float(changes.max()), "update_gap_median": float(np.median(changes)),
    }


def leaf_gaps(got: dict, want: dict, names: list) -> np.ndarray:
    """|got - want| / max(want, the median of want), for each of ``names``."""
    med = float(np.median([want[n] for n in names]))
    return np.array([abs(got[n] - want[n]) / max(want[n], med) for n in names])
