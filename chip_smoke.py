"""On-card smoke test of the PyTorch/H100 port (``applecider_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device and build: the card's name and power limit, then every kernel of
   the serving path built from ``applecider_tpu_torch/csrc`` with nvcc;
2. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, in f32 and bf16, with kernel, plain
   and (where one PyTorch call computes the same function) library times;
3. the serving path at the full published AppleCider widths: 2048
   synthetic alerts through ``LengthBinnedFeeder(FusedSpectraStream)`` in
   bf16, with every kernel's launch count read from that run alone; then
   256 alerts in f32 (TF32 off) through the kernel path and the plain path
   with the same weights;
4. one JSON line describing each kernel, then the result line.

It imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phase 1
def device_and_build() -> str:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU")
    from applecider_tpu_torch.device import card_name_and_power
    from applecider_tpu_torch.ops import kernel

    card = card_name_and_power()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernel.build()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: {', '.join(kernel.SOURCES)}")
    for name, text in kernel.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")
    return card


# ------------------------------------------------------------- phase 2
def _merge_inputs(rng, B, P, dev):
    import torch

    t = np.sort(rng.uniform(0, 30, (B, P)), axis=1).astype(np.float32)
    n_valid = rng.integers(0, P + 1, B)
    n_valid[:8] = 0  # empty rows
    valid = np.arange(P)[None, :] < n_valid[:, None]
    t[8:40] = np.round(t[8:40] * 4.0) / 4.0  # duplicate times and gaps of exactly dt
    t = np.where(valid, t, np.inf).astype(np.float32)
    band = rng.integers(0, 3, (B, P)).astype(np.int32)
    band[40:72] = rng.integers(-1, 5, (32, P))  # out-of-range bands
    return (torch.from_numpy(t).to(dev), torch.from_numpy(band).to(dev),
            torch.from_numpy(valid).to(dev))


def check_merge_scan(rng, dev) -> dict:
    from applecider_tpu_torch.ops import merge_scan as ms

    rec = None
    for P in (63, 257):
        B = 1024
        t, band, valid = _merge_inputs(rng, B, P, dev)
        got = ms.seg_ids(t, band, valid, 0.5)
        want = ms.seg_ids_reference(t, band, valid, 0.5)
        err = int((got - want).abs().max().item())
        ok = err == 0
        ms_k = time_ms(lambda: ms.seg_ids(t, band, valid, 0.5))
        ms_p = time_ms(lambda: ms.seg_ids_reference(t, band, valid, 0.5), iters=2, reps=3)
        nbytes = B * P * (4 + 4 + 1) + B * P * 4
        b_ms, b_by = bound_ms(nbytes, 0.0, "float32")
        log(f"K1 merge_scan B={B} P={P}: max|d|={err} (exact required) "
            f"kernel {ms_k:.4f} ms plain {ms_p:.4f} ms bound {b_ms:.5f} ms ({b_by}) "
            f"library none {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at P={P}")
        if P == 257:
            rec = dict(name="merge_scan", route="cuda", source="applecider_tpu_torch/csrc/merge_scan.cu",
                       replaces="applecider_tpu/ops/merge_scan.py:48", shape=f"B={B} P={P}",
                       dtype="float32", max_abs_err=float(err), ms=ms_k, plain_ms=ms_p,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return rec


def _tol_ok(got, want, dtype) -> tuple[float, bool]:
    """f32: |d| <= 1e-5. bf16: |d| <= 2e-2 * max(1, |plain|): the two
    versions round their f32 results to bf16 once each (P and the output),
    and values whose f32 results differ in the last bits may round one bf16
    step (relative 2^-8) apart."""
    import torch

    d = (got.float() - want.float()).abs()
    err = float(d.max().item()) if d.numel() else 0.0
    if dtype == torch.float32:
        return err, err <= 1e-5
    lim = 2e-2 * torch.clamp(want.float().abs(), min=1.0)
    return err, bool((d <= lim).all().item())


def check_attention(rng, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from applecider_tpu_torch.ops import attention as at

    rec = None
    B, H, hd = 256, 8, 16
    for L in (64, 258):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.normal(size=(B, H, L, hd)).astype(np.float32))
                       .to(dev, dtype) for _ in range(3))
            lengths = rng.integers(1, L + 1, B)
            mask = torch.from_numpy(np.arange(L)[None, :] >= lengths[:, None]).to(dev)
            got = at.masked_attention(q, k, v, mask)
            want = at.masked_attention_reference(q, k, v, mask)
            err, ok = _tol_ok(got, want, dtype)
            ms_k = time_ms(lambda: at.masked_attention(q, k, v, mask))
            ms_p = time_ms(lambda: at.masked_attention_reference(q, k, v, mask))
            keep = ~mask[:, None, None, :]
            ms_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
            esize = q.element_size()
            nbytes = 4 * B * H * L * hd * esize + B * L
            ops = 4.0 * B * H * L * L * hd
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            b_ms, b_by = bound_ms(nbytes, ops, dname)
            log(f"K2 attention B={B} H={H} L={L} hd={hd} {dname}: max|d|={err:.3g} "
                f"kernel {ms_k:.4f} ms plain {ms_p:.4f} ms sdpa {ms_l:.4f} ms "
                f"bound {b_ms:.5f} ms ({b_by}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version at L={L} {dname}")
            if L == 258 and dtype == torch.bfloat16:
                rec = dict(name="masked_attention", route="cuda",
                           source="applecider_tpu_torch/csrc/attention.cu",
                           replaces="applecider_tpu/ops/attention.py:35",
                           shape=f"B={B} H={H} L={L} hd={hd}", dtype=dname, max_abs_err=err,
                           ms=ms_k, plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=ms_l)
    return rec


# (C, L_stage) of every SpectraBlock epilogue at the published widths
LN_GELU_SHAPES = ((192, 3481), (384, 870), (768, 217), (1536, 54), (3072, 13))


def check_ln_gelu(rng, dev, rows: int = 97) -> dict:
    import torch

    from applecider_tpu_torch.ops import ln_gelu as lg

    rec = None
    for C, L in LN_GELU_SHAPES:
        N = rows * L
        x32 = torch.from_numpy((rng.normal(size=(N, C)) * 2.0 + 0.5).astype(np.float32)).to(dev)
        scale = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(0.0, 0.1, C).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            got = lg.ln_gelu(x, scale, bias)
            want = lg.ln_gelu_reference(x, scale, bias)
            err, ok = _tol_ok(got, want, dtype)
            ms_k = time_ms(lambda: lg.ln_gelu(x, scale, bias))
            ms_p = time_ms(lambda: lg.ln_gelu_reference(x, scale, bias))
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            nbytes = 2 * N * C * x.element_size() + 2 * C * 4
            b_ms, b_by = bound_ms(nbytes, 20.0 * N * C, dname)
            log(f"K3f ln_gelu N={N} C={C} (L_stage={L}) {dname}: max|d|={err:.3g} "
                f"kernel {ms_k:.4f} ms plain {ms_p:.4f} ms bound {b_ms:.5f} ms ({b_by}) "
                f"library none {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K3f disagrees with its plain version at C={C} {dname}")
            if C == 192 and dtype == torch.float32:
                rec = dict(name="ln_gelu_fwd", route="cuda", source="applecider_tpu_torch/csrc/ln_gelu.cu",
                           replaces="applecider_tpu/ops/ln_gelu.py:78", shape=f"N={N} C={C}",
                           dtype=dname, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
        del x32
    return rec


def check_kernels() -> list[dict]:
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    return [check_merge_scan(rng, dev), check_attention(rng, dev), check_ln_gelu(rng, dev)]


# ------------------------------------------------------------- phase 3
def kernel_counters() -> dict:
    from applecider_tpu_torch.ops import attention, ln_gelu, merge_scan

    return {"merge_scan": merge_scan.KERNEL, "masked_attention": attention.KERNEL,
            "ln_gelu_fwd": ln_gelu.KERNEL}


def serve(feeder, samples: list, num_classes: int) -> tuple[np.ndarray, int, float]:
    """Every sample through ``feeder``; (probabilities in sample order,
    batches, wall seconds from the first submit to the last result)."""
    import torch

    if feeder.router.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = feeder.submit(list(enumerate(samples))) + feeder.flush()
    probs = np.full((len(samples), num_classes), np.nan, np.float32)
    for idx, resolve in pending:
        probs[np.asarray(idx)] = resolve()
    return probs, len(pending), time.perf_counter() - t0


def check_serving(cfg=None, device="cuda", n_alerts: int = 2048, flush_bs: int = 512,
                  n_parity: int = 256, card: str = "") -> dict:
    """Phase 3: the full serving path in bf16 (counted run), then the kernel
    path against the plain path in f32 with TF32 off."""
    import torch

    from applecider_tpu_torch.infer.stream import (
        LENGTH_BUCKETS, FusedSpectraStream, LengthBinnedFeeder,
    )
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.testing import make_alert_samples

    samples = make_alert_samples(n_alerts, seed=1, spectrum_frac=0.3, length_range=(20, 257),
                                 spectrum_points=(80, 2000))
    t0 = time.perf_counter()
    model = build_fusion_model(cfg, device=device, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model built in {time.perf_counter() - t0:.1f} s: {n_params} parameters, bf16 compute")
    stream = FusedSpectraStream(model, device=device)

    def feeder():
        return LengthBinnedFeeder(stream, flush_bs=flush_bs, device=device)

    _, _, warm_s = serve(feeder(), samples, model.num_classes)  # first launches, cuDNN plans
    log(f"warm-up pass: {warm_s:.3f} s")
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    probs, n_batches, secs = serve(feeder(), samples, model.num_classes)
    launches = {name: k.launches for name, k in counters.items()}

    sums = probs.sum(axis=1)
    if probs.shape != (n_alerts, model.num_classes) or not np.isfinite(probs).all():
        raise SystemExit(f"serving output not finite of shape ({n_alerts}, {model.num_classes})")
    bad = int((np.abs(sums - 1.0) > 1e-3).sum())
    if bad:
        raise SystemExit(f"{bad} probability rows do not sum to 1 within 1e-3")
    log(f"serving bf16: {n_alerts} alerts in {n_batches} batches of flush_bs={flush_bs}, "
        f"{secs:.4f} s, {n_alerts / secs:.1f} alerts/s [{card}]; "
        f"max |sum-1| {float(np.abs(sums - 1).max()):.3g}")
    log(f"launches in that run: {launches} ({n_batches} batches)")
    if str(device).startswith("cuda"):
        missing = [n for n, c in launches.items() if c == 0]
        if missing:
            raise SystemExit(f"the serving path never launched: {missing}")

    # f32, TF32 off: kernel path vs plain path, same weights and alerts
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = build_fusion_model(cfg, device=device, dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    sub = samples[:n_parity]
    got = FusedSpectraStream(model32, device=device)(sub, length_buckets=LENGTH_BUCKETS)
    want = FusedSpectraStream(model32, device=device, kernels=False)(sub, length_buckets=LENGTH_BUCKETS)
    err = float(np.abs(got - want).max())
    log(f"f32 (TF32 off) kernel path vs plain path, {n_parity} alerts: max|dprob| = {err:.3g} "
        f"(<= 1e-4 required)")
    if not err <= 1e-4:
        raise SystemExit("f32 serving path disagrees with the plain path")
    return {"launches": launches, "batches": n_batches, "alerts_per_s": n_alerts / secs,
            "parity_err": err}


def main() -> int:
    import torch

    card = device_and_build()
    records = check_kernels()
    serving = check_serving(card=card)
    for r in records:
        r["launches"] = serving["launches"][r["name"]]
    log(json.dumps({"kernels": records}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
