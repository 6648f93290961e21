"""Where the single-modality training steps' time goes on the card.

    python3 -m applecider_tpu_torch.tools.profile_tasks

Builds ``SpectraNetTask`` and ``SpectraNetTriPoolTask`` from
``configs/spectra.toml`` (batch 32, 3,481-bin spectra) and ``AstroMiNNTask``
from ``configs/astrominn.toml`` (batch 64, 63 x 63 cutouts) at the
published widths, weights from seed 0, and for each, in bf16, in f32
(TF32 on, as the runtime runs) and in bf16 with cuDNN's autotuner on
(``torch.backends.cudnn.benchmark``, off by default: cuDNN's heuristic
then picks each convolution's algorithm), after warm-up steps on staged
batches:

1. the step's phases from CUDA events (forward + loss, backward, clip +
   AdamW), the median of 5;
2. three steps under ``torch.profiler``: device busy time summed over
   kernels and copies (the idle share is the rest of the wall time) and
   the kernels that took the most device time.

Needs a GPU; prints the card's name and power limit first and the whole
report as one JSON line last.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import torch

from applecider_tpu_torch.config import load_config
from applecider_tpu_torch.device import card_name_and_power
from applecider_tpu_torch.models.astrominn import AstroMiNNTask
from applecider_tpu_torch.models.spectranet import SpectraNetTask, SpectraNetTriPoolTask
from applecider_tpu_torch.tools.profile_training import profile_steps, step_phases
from applecider_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parents[2]
WORKDIR = REPO / "build" / "profile_tasks"
TASKS = (("SpectraNet", SpectraNetTask, "spectra"),
         ("SpectraNetTriPool", SpectraNetTriPoolTask, "spectra"),
         ("AstroMiNN", AstroMiNNTask, "astrominn"))


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


VARIANTS = (("bfloat16", False), ("float32", False), ("bfloat16", True))


def profile_task(name: str, cls, config: str, dtype: str) -> dict:
    cfg = load_config(REPO / "configs" / f"{config}.toml",
                      {"train": {"compute_dtype": dtype}})
    task = cls(cfg, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(task, cfg, WORKDIR / f"{name}_{dtype}")
    batches = [trainer.to_device(h) for h in
               host_batches(config, int(cfg.get_path("data_loader.batch_size")))]
    for b in batches:  # first launches, cuDNN plans
        trainer.train_step(b)
    phases = [step_phases(trainer, batches[i % len(batches)]) for i in range(5)]
    phases = {k: float(np.median([p[k] for p in phases])) for k in phases[0]}
    prof = profile_steps(trainer, batches)
    prof["top"] = prof["top"][:8]
    return {"batch": len(batches[0][0]), "phases": phases, "profile": prof}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_tasks needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    report = {}
    for name, cls, config in TASKS:
        for dtype, autotune in VARIANTS:
            torch.backends.cudnn.benchmark = autotune
            r = profile_task(name, cls, config, dtype)
            what = f"{dtype}{', cuDNN autotuned' if autotune else ''}"
            report[f"{name}_{dtype}{'_autotuned' if autotune else ''}"] = r
            p, prof = r["phases"], r["profile"]
            print(f"{name} {what}, batch {r['batch']}: step {p['step_ms']:.3f} ms (forward "
                  f"{p['forward_ms']:.3f}, backward {p['backward_ms']:.3f}, clip + AdamW "
                  f"{p['clip_adam_ms']:.3f}); {prof['steps']} steps under the profiler: wall "
                  f"{prof['wall_ms']:.2f} ms, device busy {prof['device_busy_ms']:.2f} ms, idle "
                  f"share {prof['idle_share']}", flush=True)
            for row in prof["top"]:
                print(f"  {row['ms']:9.3f} ms {row['calls']:6d}x {row['kernel']}", flush=True)
            torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = False
    shutil.rmtree(WORKDIR, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "tasks": report}), flush=True)


if __name__ == "__main__":
    main()
