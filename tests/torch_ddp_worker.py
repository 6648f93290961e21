"""Rank bodies of ``tests/test_torch_ddp.py``: each job runs in a process
of a gloo group on the CPU and returns what the test compares.

Imports torch and the port only (no JAX), so that a spawned rank starts in
a few seconds. ``spawn(job, args, tmp, world)`` runs ``world`` ranks of
``job`` (``parallel.launch.spawn``) and returns their results in rank
order, raising a rank's error.
The group comes up through the port's own hook: each rank's config sets
``[parallel.multihost]`` with a ``file://`` rendezvous under ``tmp``, so
parallel test workers never race for a port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from applecider_tpu_torch.parallel import launch

TIMEOUT_S = 60  # the rendezvous and every collective; a hung rank fails the test


class ArrayDataset:
    """Rows of NumPy arrays (``sample``/``collate`` as the loaders take
    them); ``extra`` arrays ride along whole in every batch."""

    def __init__(self, arrays: dict, extra: dict | None = None):
        self.arrays, self.extra = arrays, dict(extra or {})

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def sample(self, i: int) -> dict:
        return {k: v[i] for k, v in self.arrays.items()}

    def collate(self, samples: list) -> dict:
        return {"data": {**{k: np.stack([s[k] for s in samples]) for k in self.arrays},
                         **self.extra}}


def config(overrides: dict, tmp: Path, world: int, rank: int):
    """The port's defaults under ``overrides`` and, with ``world`` ranks,
    ``[parallel.multihost]`` on a rendezvous file under ``tmp``."""
    from applecider_tpu_torch.config import load_defaults

    cfg = load_defaults().merged_with(overrides)
    if world:
        cfg = cfg.merged_with({"parallel": {"multihost": {
            "enable": True, "coordinator_address": f"file://{tmp / 'rendezvous'}",
            "num_processes": world, "process_id": rank, "timeout_s": TIMEOUT_S}}})
    return cfg


def _numpy_state(module) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


# ------------------------------------------------------------------ jobs
def fit_job(rank: int, world: int, args: dict) -> dict:
    """``Trainer.fit`` of ``args["model"]`` (BaselineCLS, MPT or a zoo
    task) on the rank's shard of ``args["train"]``, validated and predicted
    on ``args["val"]``; ``world`` 0 runs one process without a group."""
    from applecider_tpu_torch.models import mpt

    drawn = mpt.band_stratified_mask
    if args.get("row_mask"):  # the MPT mask, injected: a function of the rows
        mpt.band_stratified_mask = _row_mask
    try:
        return _fit(rank, world, args)
    finally:
        mpt.band_stratified_mask = drawn


def _fit(rank: int, world: int, args: dict) -> dict:
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.registry import get_model
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = config(args["overrides"], args["tmp"], world, rank)
    task = get_model(cfg.get_path("model.name"))(cfg, device="cpu",
                                                 generator=torch.Generator().manual_seed(0))
    train = ArrayDataset(args["train"], args.get("extra"))
    task.init(task.to_tensor(train.collate([train.sample(i) for i in range(2)])))  # a zoo model
    trainer = Trainer(task, cfg, args["tmp"] / "run", device="cpu")
    shards = {"num_shards": trainer.mesh.shape["data"], "shard_index": trainer.data_index}

    def loader(ds, batch):
        return DataLoader(ds, batch_size=batch, shuffle=False, prefetch=0, **shards)

    val = ArrayDataset(args["val"], args.get("extra")) if "val" in args else None
    b = args["batch"] // trainer.mesh.shape["data"]
    out = trainer.fit(loader(train, b), loader(val, b) if val else None,
                      epochs=args["epochs"], init_params=args.get("init"))
    res = {"history": out["history"], "state": _numpy_state(trainer.model),
           "mesh": dict(trainer.mesh.shape),
           "grads": {k: v.grad.numpy().copy() for k, v in trainer.model.named_parameters()
                     if v.grad is not None},
           "files": sorted(str(p.relative_to(args["tmp"])) for p in
                           (args["tmp"] / "run").rglob("*") if p.is_file())}
    if val is not None and args.get("predict_batch"):
        res["predict"] = trainer.predict(loader(val, args["predict_batch"]))
    return res


def _row_mask(bands, pad_mask, p, generator=None):
    """A mask that is a function of the events alone (every third valid
    event by band and position), so that one rank and two mask the same
    rows."""
    pos = torch.arange(bands.shape[1], device=bands.device)[None, :]
    return ((pos + bands) % 3 == 0) & ~pad_mask


def runtime_job(rank: int, world: int, args: dict) -> dict:
    """The runtime's verbs on a corpus: ``train``, ``infer``, and a predict
    at batch 3 that leaves rows no shard emits."""
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    rt = AppleCiderRuntime(overrides=config(args["overrides"], args["tmp"], world, rank), workdir=args["workdir"], device="cpu")
    rt.prepare()
    res = rt.train()
    preds = rt.infer()
    trainer = rt._restore_latest(rt._task())
    odd = DataLoader(rt.datasets["infer"], batch_size=3, shuffle=False, prefetch=0,
                     num_shards=trainer.mesh.shape["data"], shard_index=trainer.data_index)
    return {"losses": [h["train_loss"] for h in res["history"]],
            "val": [{k: v for k, v in h.items() if k.startswith("val_")} for h in res["history"]],
            "run_dir": str(res["run_dir"]), "preds": preds, "preds_odd": trainer.predict(odd),
            "odd_leftover": odd.shard_emit_plan()["leftover"].tolist(),
            "dirs": sorted(p.name for p in Path(args["workdir"]).iterdir()),
            "metrics_lines": len((res["run_dir"] / "metrics.jsonl").read_text().splitlines())}


def streams_job(rank: int, world: int, args: dict) -> dict:
    """The three streams with ``mesh=`` beside the same streams without, on
    the same weights and alerts."""
    from applecider_tpu_torch.infer.stream import (
        AlertStreamPipeline, FusedSpectraStream, RoutedAlertStream, pack_alert_batch,
    )
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.parallel.mesh import make_mesh
    from applecider_tpu_torch.parallel.multihost import maybe_initialize
    from applecider_tpu_torch.testing import make_alert_samples

    cfg = config(args["overrides"], args["tmp"], world, rank)
    maybe_initialize(cfg, "cpu")
    mesh = make_mesh()
    model = build_fusion_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    kw = {"wave_grid": args["grid"], "device": "cpu"}
    out = {}
    for n in (8, 7):  # rows that divide over the ranks, and ragged rows
        samples = make_alert_samples(n, seed=n, spectrum_frac=0.4, length_range=(5, 40))
        raw = {k: torch.from_numpy(v) for k, v in
               pack_alert_batch(samples, max_photo=48, max_spec=64).items()}
        out[f"pipeline_{n}"] = (AlertStreamPipeline(model, mesh=mesh, **kw)(raw).numpy(),
                                AlertStreamPipeline(model, **kw)(raw).numpy())
        out[f"routed_{n}"] = (
            RoutedAlertStream(model, batch_buckets=(4, 8), mesh=mesh, **kw)(samples),
            RoutedAlertStream(model, batch_buckets=(4, 8), **kw)(samples))
        fused = FusedSpectraStream(model, mesh=mesh, **kw)
        placed = fused.place(samples, length_buckets=(32, 64))
        out[f"fused_{n}"] = (fused.run_placed(placed)(),
                             FusedSpectraStream(model, **kw)(samples, length_buckets=(32, 64)))
        out[f"fused_{n}_local_rows"] = int(placed["image"].shape[0])
    return out


def dropout_job(rank: int, world: int, args: dict) -> dict:
    """Each rank's first draws of the Trainer's generators: a dropout site's
    mask, K4 seeds and an MPT mask; then one step with dropout live."""
    from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
    from applecider_tpu_torch.models.mpt import band_stratified_mask
    from applecider_tpu_torch.ops.dropout import SEED_BOUND, FastDropout
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = config(args["overrides"], args["tmp"], world, rank)
    trainer = Trainer(BaselineCLSTask(cfg, device="cpu", generator=torch.Generator().manual_seed(0)),
                      cfg, args["tmp"] / "run", device="cpu")
    site = next(m for m in trainer.model.modules() if isinstance(m, FastDropout))
    site.train()
    x = torch.ones(64, 64)
    res = {"dropout": (site(x) == 0).numpy(),
           "k4_seeds": torch.randint(0, SEED_BOUND, (4,), generator=trainer.rng.cpu).tolist()}
    bands = torch.randint(0, 3, (8, 40), generator=torch.Generator().manual_seed(1))
    res["mpt_mask"] = band_stratified_mask(bands, torch.zeros(8, 40, dtype=torch.bool), 0.3,
                                           trainer.rng.device).numpy()
    rng = np.random.default_rng(rank)
    batch = (torch.from_numpy(rng.normal(size=(4, 20, 7)).astype(np.float32)),
             torch.zeros(4, 20, dtype=torch.bool), torch.from_numpy(rng.integers(0, 5, 4)))
    res["step_loss"] = float(trainer.train_step(batch)["loss"])
    return res


def mesh_groups_job(rank: int, world: int, args: dict) -> dict:
    """``make_mesh(shape)`` called twice: whether each axis's group is the
    same object both times, and how many process groups the calls made."""
    import torch.distributed as dist

    from applecider_tpu_torch.parallel import mesh as mesh_mod
    from applecider_tpu_torch.parallel.multihost import maybe_initialize

    maybe_initialize(config({}, args["tmp"], world, rank), "cpu")
    made = []
    new_group = dist.new_group

    def counted(*a, **k):
        made.append(a[0] if a else k.get("ranks"))
        return new_group(*a, **k)

    dist.new_group = counted
    try:
        first = mesh_mod.make_mesh(args["shape"])
        after_first = len(made)
        second = mesh_mod.make_mesh(args["shape"])
    finally:
        dist.new_group = new_group
    x = torch.full((1,), float(rank + 1))
    if "data" in second.groups:  # a collective over the reused group still runs
        dist.all_reduce(x, group=second.group("data"))
    return {"axes": sorted(first.groups), "same": {a: second.groups[a] is g
                                                   for a, g in first.groups.items()},
            "made_first": after_first, "made_second": len(made) - after_first,
            "data_sum": float(x[0])}


def frozen_fusion_job(rank: int, world: int, args: dict) -> dict:
    """The fusion model at tiny widths in f32, dropout 0: ``steps`` steps of
    a global batch (split over the ranks) from seed 0, with
    ``train.freeze_params`` = ``args["freeze"]``, then ``predict`` in dataset
    order on the trained weights."""
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.fusion import AppleCiderTask
    from applecider_tpu_torch.ops.dropout import FastDropout
    from applecider_tpu_torch.testing import SyntheticFusionDataset
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = config({**args["overrides"], "train": {**args["overrides"].get("train", {}),
                                                 "freeze_params": args["freeze"]}},
                 args["tmp"], world, rank)
    model = build_fusion_model(cfg, device="cpu", dtype=torch.float32,
                               generator=torch.Generator().manual_seed(0))
    for m in model.modules():  # AstroMiNN's dropout rates are fixed, not configured
        if isinstance(m, FastDropout):
            m.rate = 0.0
    trainer = Trainer(AppleCiderTask(cfg, model), cfg, args["tmp"] / "run", device="cpu")
    shards = {"num_shards": trainer.mesh.shape["data"], "shard_index": trainer.data_index}
    data = {k: args[k] for k in ("max_len", "spec_bins")}
    trainer.fit(DataLoader(SyntheticFusionDataset(args["batch"] * args["steps"], seed=2, **data),
                           batch_size=args["batch"] // shards["num_shards"], shuffle=False,
                           drop_last=True, prefetch=0, **shards), epochs=1)
    infer = DataLoader(SyntheticFusionDataset(args["n_predict"], seed=3, **data),
                       batch_size=args["batch"] // shards["num_shards"], shuffle=False,
                       prefetch=0, **shards)
    return {"preds": trainer.predict(infer), "state": _numpy_state(trainer.model)}


JOBS = {"fit": fit_job, "runtime": runtime_job, "streams": streams_job, "dropout": dropout_job,
        "mesh_groups": mesh_groups_job, "frozen_fusion": frozen_fusion_job}


# ------------------------------------------------------------ launching
def run_job(rank: int, world: int, job: str, args: dict):
    torch.set_num_threads(1)  # two ranks beside the other test workers
    return JOBS[job](rank, world, args)


def spawn(job: str, args: dict, tmp: Path, world: int = 2, timeout_s: float = 180) -> list:
    """``world`` spawned ranks of ``job``; their results in rank order."""
    tmp.mkdir(parents=True, exist_ok=True)  # the rendezvous file's directory
    return launch.spawn(run_job, world, job, {**args, "tmp": tmp}, timeout_s=timeout_s)


def run_here(job: str, args: dict, tmp: Path):
    """``job`` in this process, without a process group (the reference)."""
    return JOBS[job](0, 0, {**args, "tmp": tmp})
