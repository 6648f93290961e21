"""Where the single-modality and the model zoo's training steps' time goes
on the card.

    python3 -m applecider_tpu_torch.tools.profile_tasks

Builds ``SpectraNetTask`` and ``SpectraNetTriPoolTask`` from
``configs/spectra.toml`` (batch 32, 3,481-bin spectra) and ``AstroMiNNTask``
from ``configs/astrominn.toml`` (batch 64, 63 x 63 cutouts) at the
published widths, weights from seed 0, and for each, in bf16, in f32
(TF32 on, as the runtime runs) and in bf16 with cuDNN's autotuner on
(``torch.backends.cudnn.benchmark``, off by default: cuDNN's heuristic
then picks each convolution's algorithm), after warm-up steps on staged
batches; then the model zoo's seven tasks at their published widths (the
module defaults), in bf16 only, at ``ZOO_BATCHES`` (the batches of
``chip_smoke.py`` phase 12) of N(0, 1) inputs. For each:

1. the step's phases from CUDA events (forward + loss, backward, clip +
   the optimizer: AdamW, or the zoo's Adam), the median of 5;
2. three steps under ``torch.profiler``: device busy time summed over
   kernels and copies (the idle share is the rest of the wall time) and
   the kernels that took the most device time;
3. for SpectraNet and TriPool, the route of each bank conv
   (``ops.conv1d.route``: direct, FFT or space-to-depth).

Needs a GPU; prints the card's name and power limit first and the whole
report as one JSON line last.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from applecider_tpu_torch.config import load_config, load_defaults
from applecider_tpu_torch.device import card_name_and_power
from applecider_tpu_torch.models.astrominn import AstroMiNNTask
from applecider_tpu_torch.models.spectranet import SpectraNetTask, SpectraNetTriPoolTask
from applecider_tpu_torch.registry import get_model
from applecider_tpu_torch.tools.conv_routes import module_routes
from applecider_tpu_torch.tools.profile_training import profile_steps, step_phases
from applecider_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[2]
WORKDIR = REPO / "build" / "profile_tasks"
TASKS = (("SpectraNet", SpectraNetTask, "spectra"),
         ("SpectraNetTriPool", SpectraNetTriPoolTask, "spectra"),
         ("AstroMiNN", AstroMiNNTask, "astrominn"))
# (sample shape, batch) of each zoo model at its published widths:
# BTSModel on 63 x 63 cutouts, MetaModel on the image+metadata data set's
# 24 columns, GalSpecNet on the 3,481-bin grid, Informer on 257 events of
# 7 features, the spectra baselines on 224 x 224 renders
ZOO_BATCHES = {"BTSModel": ((63, 63, 3), 256), "MetaModel": ((24,), 256),
               "GalSpecNet": ((3481,), 64), "Informer": ((257, 7), 64),
               "SpectraViT": ((224, 224, 3), 64), "SpectraEfficientNetV2": ((224, 224, 3), 32),
               "SpectraConvNeXt": ((224, 224, 3), 32)}


def host_batches(config: str, batch_size: int, n: int = 3) -> list:
    """``to_tensor`` arrays of random inputs: spectra N(0, 1) with labels
    and redshifts, or metadata, NHWC cutouts and one-hot targets."""
    rng = np.random.default_rng(0)
    if config == "spectra":
        return [(rng.normal(size=(batch_size, 3481)).astype(np.float32),
                 rng.integers(0, 9, size=batch_size).astype(np.int64),
                 rng.uniform(0.0, 0.3, size=batch_size).astype(np.float32)) for _ in range(n)]
    return [(rng.normal(size=(batch_size, 24)).astype(np.float32),
             rng.normal(size=(batch_size, 63, 63, 3)).astype(np.float32),
             np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=batch_size)]) for _ in range(n)]


def zoo_host_batches(task_cls, shape: tuple, batch: int, n: int, seed: int) -> list:
    """``n`` ``to_tensor`` batches of a zoo task: N(0, 1) inputs under its
    first input key, labels in [0, 5)."""
    rng = np.random.default_rng(seed)
    return [task_cls.to_tensor({"data": {
        task_cls.input_keys[0]: rng.normal(size=(batch, *shape)).astype(np.float32),
        "label": rng.integers(0, 5, size=batch)}}) for _ in range(n)]


VARIANTS = (("bfloat16", False), ("float32", False), ("bfloat16", True))


def profile_task(name: str, cls, config: str, dtype: str, top: int = 8,
                 overrides: dict | None = None) -> dict:
    """``config`` names a run config of ``configs/``, or is "zoo": the
    defaults and ``ZOO_BATCHES``' batch, the model sized by it; ``overrides``
    go on top. Keeps the ``top`` kernels; a spectra task's result names the
    route of each bank conv (``routes``)."""
    if config == "zoo":
        cfg = load_defaults().merged_with({"train": {"compute_dtype": dtype}, **(overrides or {})})
        task = cls(cfg, generator=torch.Generator().manual_seed(0))
        shape, batch = ZOO_BATCHES[name]
        hosts = zoo_host_batches(cls, shape, batch, 3, seed=0)
        task.init(hosts[0])
    else:
        cfg = load_config(REPO / "configs" / f"{config}.toml",
                          {"train": {"compute_dtype": dtype}, **(overrides or {})})
        task = cls(cfg, generator=torch.Generator().manual_seed(0))
        hosts = host_batches(config, int(cfg.get_path("data_loader.batch_size")))
    trainer = Trainer(task, cfg, WORKDIR / f"{name}_{dtype}")
    batches = [trainer.to_device(h) for h in hosts]
    for b in batches:  # first launches, cuDNN plans
        trainer.train_step(b)
    phases = [step_phases(trainer, batches[i % len(batches)]) for i in range(5)]
    phases = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    prof = profile_steps(trainer, batches)
    prof["top"] = prof["top"][:top]
    out = {"batch": len(batches[0][0]), "phases": phases, "profile": prof}
    if config == "spectra":
        out["routes"] = module_routes(task.module, out["batch"], batches[0][0].shape[-1])
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tasks needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    report = {}
    runs = [(name, cls, config, variant) for name, cls, config in TASKS for variant in VARIANTS]
    runs += [(name, get_model(name), "zoo", VARIANTS[0]) for name in ZOO_BATCHES]
    for name, cls, config, (dtype, autotune) in runs:
        torch.backends.cudnn.benchmark = autotune
        r = profile_task(name, cls, config, dtype)
        what = f"{dtype}{', cuDNN autotuned' if autotune else ''}"
        report[f"{name}_{dtype}{'_autotuned' if autotune else ''}"] = r
        p, prof = r["phases"], r["profile"]
        print(f"{name} {what}, batch {r['batch']}: step {p['step_ms']:.3f} ms (forward "
              f"{p['forward_ms']:.3f}, backward {p['backward_ms']:.3f}, clip + optimizer "
              f"{p['clip_adam_ms']:.3f}); {prof['steps']} steps under the profiler: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, idle "
              f"share {prof['idle_share']}", flush=True)
        for route in r.get("routes", []):
            print(f"  route: {route}", flush=True)
        for row in prof["top"]:
            print(f"  {row['ms']:9.3f} ms {row['calls']:6d}x {row['kernel']}", flush=True)
        torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    shutil.rmtree(WORKDIR, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "tasks": report}), flush=True)


if __name__ == "__main__":
    main()
