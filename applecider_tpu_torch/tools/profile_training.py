"""Where the training step's time goes on the card.

    python3 -m applecider_tpu_torch.tools.profile_training

Builds the full-width AppleCider model in bf16 from a fixed seed and trains
it with ``Trainer`` on ``SyntheticFusionDataset`` batches of 256 samples.
After warm-up steps it reports, on the card it runs on:

1. the whole step: host time per step (each ending in a synchronise),
   samples/s and peak device memory;
2. the step's phases from CUDA events: forward + loss, backward, and clip
   + Adam;
3. each encoder alone in training mode, forward and backward (of a random
   projection of its output), from CUDA events;
4. a few whole steps under ``torch.profiler``: device busy time summed over
   kernels and copies (the idle share is the rest of the wall time) and the
   kernels that took the most device time.

Needs a GPU; prints the card's name and power limit first and the whole
report as one JSON line last.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from applecider_tpu_torch.config import load_defaults
from applecider_tpu_torch.device import card_name_and_power
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.models.fusion import AppleCiderTask, to_tensor
from applecider_tpu_torch.testing import SyntheticFusionDataset
from applecider_tpu_torch.train.trainer import Trainer

BATCH = 256
WORKDIR = Path(__file__).resolve().parents[2] / "build" / "profile_training"


def step_phases(trainer: Trainer, batch) -> dict:
    """One train step with CUDA events between its phases."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    trainer.model.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = trainer.task.loss(batch)
    ev[1].record()
    loss.backward()
    ev[2].record()
    trainer.apply_gradients()
    ev[3].record()
    torch.cuda.synchronize()
    return {"forward_ms": ev[0].elapsed_time(ev[1]), "backward_ms": ev[1].elapsed_time(ev[2]),
            "clip_adam_ms": ev[2].elapsed_time(ev[3]), "step_ms": ev[0].elapsed_time(ev[3])}


def encoder_times(model, batch, reps: int = 3) -> dict:
    """Forward and backward device time of each encoder alone, train mode;
    the median of ``reps`` after one warm-up."""
    photometry, photo_mask, metadata, images, spectra, _ = batch
    encoders = {
        "photometry": lambda: model.photometry_encoder(photometry, photo_mask),
        "spectra": lambda: model.spectra_encoder(spectra),
        "img_meta": lambda: model.img_meta_encoder(metadata, images),
    }
    out = {}
    for name, fn in encoders.items():
        rows = []
        for _ in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            y = fn()
            ev[1].record()
            (y.float() * torch.randn_like(y, dtype=torch.float32)).sum().backward()
            ev[2].record()
            torch.cuda.synchronize()
            rows.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        rows = sorted(rows[1:])
        fwd = sorted(r[0] for r in rows)[len(rows) // 2]
        bwd = sorted(r[1] for r in rows)[len(rows) // 2]
        out[name] = {"forward_ms": fwd, "backward_ms": bwd}
    model.zero_grad(set_to_none=True)
    return out


def profile_steps(trainer: Trainer, batches: list) -> dict:
    """Whole steps under torch.profiler: wall, device busy, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):  # kernels and copies, not the CPU ops
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"steps": len(batches), "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": None if not rows else 1.0 - busy / (wall * 1e3),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:20]]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    cfg = load_defaults()
    model = build_fusion_model(cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    shutil.rmtree(WORKDIR, ignore_errors=True)
    trainer = Trainer(AppleCiderTask(cfg, model), cfg, WORKDIR)
    data = SyntheticFusionDataset(BATCH * 4, seed=2)
    batches = [trainer.to_device(to_tensor(data.collate([data.sample(i) for i in range(s, s + BATCH)])))
               for s in range(0, BATCH * 4, BATCH)]
    torch.cuda.reset_peak_memory_stats()
    for b in batches[:2]:  # first launches, cuDNN plans
        trainer.train_step(b)
    torch.cuda.synchronize()
    host = []
    for b in batches * 2:
        t0 = time.perf_counter()
        trainer.train_step(b)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    host.sort()
    step = {"host_step_ms_median": host[len(host) // 2], "host_step_ms_all": host,
            "samples_per_s": BATCH / host[len(host) // 2] * 1e3, "peak_gib": peak / 2**30}
    print(f"step: median {step['host_step_ms_median']:.2f} ms over {len(host)} steps, "
          f"{step['samples_per_s']:.1f} samples/s, peak {step['peak_gib']:.2f} GiB", flush=True)
    phases = [step_phases(trainer, b) for b in batches]
    phases = {k: sorted(p[k] for p in phases)[len(phases) // 2] for k in phases[0]}
    print("phases " + " ".join(f"{k}={v:.3f}" for k, v in phases.items()), flush=True)
    enc = encoder_times(model, batches[0])
    for name, r in enc.items():
        print(f"encoder {name}: forward {r['forward_ms']:.3f} ms backward {r['backward_ms']:.3f} ms",
              flush=True)
    prof = profile_steps(trainer, batches[:3])
    print(f"{prof['steps']} steps under the profiler: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']}", flush=True)
    for row in prof["top"]:
        print(f"  {row['ms']:9.3f} ms {row['calls']:6d}x {row['kernel']}", flush=True)
    shutil.rmtree(WORKDIR, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "batch": BATCH, "step": step, "phases": phases,
                      "encoders": enc, "profile": prof}), flush=True)


if __name__ == "__main__":
    main()
