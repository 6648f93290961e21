"""Where the serving path's time goes on the card.

    python3 -m applecider_tpu_torch.tools.profile_serving

Builds the full-width AppleCider model in bf16 from a fixed seed and
streams synthetic alerts (30% with a spectrum, light curves of 20-257
points) through ``LengthBinnedFeeder(FusedSpectraStream)``. After a warm-up
pass it reports, on the card it runs on:

1. for one full batch of each length bucket: host packing time, the
   host-to-device copy, and the device time of each layer (preprocessing,
   photometry encoder, spectra encoder, image+metadata encoder, and the
   rest: projections, fusion head, softmax), from CUDA events; and, inside
   preprocessing, the merge's group-start kernel K1 (``k1_ms``: events
   around its call, so it holds the host's enqueue of the call where the
   card waits on it; ``k1_launch_ms`` by the host clock);
2. for one whole pass: wall time, the device's busy time summed over
   kernels from ``torch.profiler`` (the idle share is the rest), and the
   kernels that took the most device time.

Needs a GPU; prints the card's name and power limit first and the whole
report as one JSON line last. Run by path with another checkout's root on
``PYTHONPATH`` (``PYTHONPATH=<root> python3 <this file>``), it times that
checkout's package with this script, for an A/B in one call.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from applecider_tpu_torch.device import card_name_and_power
from applecider_tpu_torch.infer import stream as stream_module
from applecider_tpu_torch.infer.stream import LENGTH_BUCKETS, FusedSpectraStream, LengthBinnedFeeder
from applecider_tpu_torch.models import build_fusion_model
from applecider_tpu_torch.testing import make_alert_samples

FLUSH_BS = 512


@contextlib.contextmanager
def k1_calls():
    """Within the block, each call of K1 by the serving path (``seg_ids`` as
    ``infer.stream`` calls it) records a CUDA event before and after it and
    its host time; yields the list of (start, end, host seconds)."""
    inner = stream_module.seg_ids
    calls = []

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        calls.append((start, end, time.perf_counter() - t0))
        return out

    stream_module.seg_ids = timed
    try:
        yield calls
    finally:
        stream_module.seg_ids = inner


@torch.inference_mode()
def layer_times(stream: FusedSpectraStream, samples: list, bucket: int) -> dict:
    """Host and per-layer times of one batch of ``FLUSH_BS`` rows.

    One forward, with a CUDA event recorded between its stages: the device
    time between two events is the stage's work or, when Python launches
    the stage's kernels slower than the card runs them, its launch time.
    ``*_launch_ms`` is the host time spent issuing each stage."""
    pipe, model = stream.pipe, stream.pipe.model
    t0 = time.perf_counter()
    packed = stream.place(samples, length_buckets=(bucket,), pad_to=FLUSH_BS, host_only=True)
    t1 = time.perf_counter()
    placed = stream.place_packed(packed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    names = ("preprocess", "photometry", "spectra", "img_meta", "head")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    host = [time.perf_counter()]
    ev[0].record()
    with k1_calls() as k1:
        x = pipe.preprocess(placed)
    stages = (
        lambda: model.photometry_encoder(x["photometry"], x["photo_mask"]),
        lambda: model.spectra_encoder(x["spectra"]),
        lambda: model.img_meta_encoder(x["metadata"], x["images"]),
        lambda: torch.softmax(model.fuse(*outs, x["spec_gather"]), dim=-1),
    )
    host.append(time.perf_counter())
    ev[1].record()
    outs = []
    for i, stage in enumerate(stages):
        outs.append(stage())
        host.append(time.perf_counter())
        ev[i + 2].record()
    torch.cuda.synchronize()
    row = {"bucket": bucket, "rows": FLUSH_BS, "real_alerts": len(samples),
           "spectra_rows": int(placed["spec_wl"].shape[0]),
           "host_pack_ms": (t1 - t0) * 1e3, "h2d_ms": (t2 - t1) * 1e3}
    for i, name in enumerate(names):
        row[f"{name}_ms"] = ev[i].elapsed_time(ev[i + 1])
        row[f"{name}_launch_ms"] = (host[i + 1] - host[i]) * 1e3
    (k1_start, k1_end, k1_host), = k1
    row["k1_ms"] = k1_start.elapsed_time(k1_end)
    row["k1_launch_ms"] = k1_host * 1e3
    row["forward_ms"] = ev[0].elapsed_time(ev[-1])
    return row


def profile_pass(feeder_fn, samples: list) -> dict:
    """One whole pass under torch.profiler: wall, device busy, top kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feeder = feeder_fn()
        for _, resolve in feeder.submit(list(enumerate(samples))) + feeder.flush():
            resolve()
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
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": None if not rows else 1.0 - busy / (wall * 1e3),
            "top": [{"kernel": k[:90], "ms": ms, "calls": c} for k, ms, c in rows[:15]]}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    model = build_fusion_model(device="cuda", dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    stream = FusedSpectraStream(model)
    samples = make_alert_samples(2048, seed=1)

    def feeder():
        return LengthBinnedFeeder(stream, flush_bs=FLUSH_BS)

    warm = feeder()
    for _, resolve in warm.submit(list(enumerate(samples))) + warm.flush():
        resolve()

    by_bucket = {b: [] for b in LENGTH_BUCKETS}
    for s in samples:
        n = len(s["photo_t"])
        by_bucket[next(b for b in LENGTH_BUCKETS if b >= n)].append(s)
    layers = []
    for b in LENGTH_BUCKETS:
        if by_bucket[b]:
            layer_times(stream, by_bucket[b][:FLUSH_BS], b)  # this shape's first launches
            layers.append(layer_times(stream, by_bucket[b][:FLUSH_BS], b))
    for r in layers:
        print("layers " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                   for k, v in r.items()), flush=True)
    prof = profile_pass(feeder, samples)
    print(f"pass of {len(samples)} alerts: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['device_busy_ms']:.2f} ms, idle share {prof['idle_share']}", flush=True)
    for row in prof["top"]:
        print(f"  {row['ms']:9.3f} ms {row['calls']:6d}x {row['kernel']}", flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "layers": layers, "profile": prof}), flush=True)


if __name__ == "__main__":
    main()
