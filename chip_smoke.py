"""On-card smoke test of the PyTorch/H100 port (``applecider_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device and build: the card's name and power limit, then every kernel of
   the serving and training paths built from ``applecider_tpu_torch/csrc``
   with nvcc, one process per source, all started together, and the native
   stamp decoder (``applecider_tpu_torch/native``) with g++ (its variant:
   libdeflate or zlib);
2. each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it, with kernel, plain, bound and (where one
   PyTorch call computes the same function) library times: K1 exactly,
   twice bit for bit and with the number of rows it must walk with the
   recurrence (none in the serving layout), on serving-layout rows at
   every serving length, at warp edges and past a block's 1024 threads
   (P up to 5000, B = 1 and 513), on rows of one group and of a group a
   point, and on rows not time-ascending, with NaN and -inf times and with
   holes, then timed (``tools/kernel_timing.py``) at B = 1024 P = 257 and
   B = 512 at each serving length, as every kernel and with the calls
   queued (the device alone); K3f as the serving path runs it; K2 in f32
   and bf16 at 16-row tile tails (L = 1, 17, 33), at every serving length
   (L = 64, 128, 192, 256, 258, B = 512) and at head widths 8 and 32, each
   with a fully masked batch row, timed at the train shape and the
   serving shape; K4 forward and backward on injected bits in f32 and
   bf16, at the same tails and head widths; HMMA (tensor-core) instructions in the SASS of every bf16 K2
   and K4 instantiation (the K4x rungs' too) and none in the FMA kernels'
   (all f32), and no other kernel; K4's Philox bits against their twin bit for
   bit, the Philox kernels against the bits kernels fed the same keep mask
   at the same tails and head widths, the export at rate 0, and the keep
   rate over the train shape; K4 forward and backward timed at the train
   shape with Philox and at rate 0; K3b in f32 and bf16 at every SpectraNet
   stage, at ragged row counts, odd widths and rows too wide for its
   registers, with misaligned rows and twice on the same inputs (bitwise
   equal), then at each of the five train-shape stages checked in f32 and
   timed beside PyTorch's own LN+GELU backward (and no K3b instantiation
   spilling registers in phase 1); K4x, the
   forward ablation ladder, whose rungs are instantiations of K4a's forward
   (bf16: the tensor-core kernel): every rung against its plain version in
   f32 and bf16, on prefix-length masks at the same tails and head widths,
   with no padded key, and on the ladder's own inputs (B = 256, random
   mask), ``full`` equal to K4a's forward and ``no_prng`` to its rate-0
   forward, ``prng_only_no_apply`` and ``batched4/8`` to ``no_prng``, all
   bit for bit, a ``batched{N}`` over a block's shared memory refused, and
   ``prng_only_no_apply``'s Philox draw present in its SASS; then the
   ladder's own path, ``tools/flash_microab.ladder`` at the train shape,
   with each rung's launch count read from that run alone, and its ``full``
   timed beside K4a's ``flash_forward(seed=)`` in turns;
3. the serving path at the full published AppleCider widths: 2048
   synthetic alerts through ``LengthBinnedFeeder(FusedSpectraStream)`` in
   bf16, with every kernel's launch count read from that run alone; then
   256 alerts in f32 (TF32 off) through the kernel path and the plain path
   with the same weights; K1 must walk none of the serving rows;
3b. raw-alert serving, with phase 3's weights: 128 ZTF-layout object
   directories written by ``testing.make_corpus`` (16 alerts each, light
   curves of U(20, 300) points, 30% with a spectrum, gzipped FITS stamps)
   read and decoded on the host alone (host ms, and its split, the stamps
   decoded by the native decoder as the reader calls it, beside the same
   stamps decoded on one thread natively and in Python), then served from the
   directories through ``serve_alert_stream(model, iter_alert_samples(dir))``
   in bf16 (alerts/s, host reading included), with K1, K2 and K3f's launch
   counts read from that run alone; then, in f32 with TF32 off on the first
   256 alerts, binned against arrival order, ``RoutedAlertStream`` against
   ``FusedSpectraStream`` and the kernel path against the plain path
   (each <= 1e-4), and ``OverlappedServingFeeder`` in thread and process
   mode on records carrying stamps against the serial router (<= 1e-6);
4. the training step at the full widths in bf16: ``Trainer.fit`` for one
   epoch of 12 steps of 256 samples, with the launch counts of K4 forward,
   K4 backward, K3f and K3b read from that run alone, a checkpoint written
   and resumed; then the attention's route by autograd and mode;
5. training parity: one f32 step (TF32 off, 32 samples, dropout live) on
   the kernel path and on the plain path with the same weights and the
   same dropout draws;
6. the user's workflow through its own entry points, at the published
   widths: a raw corpus (``testing.make_corpus``, 96 learnable objects, 8
   alerts each, 30% with a spectrum) -> ``preprocess_data`` serially and in
   a spawn pool of 4 (the same files, every object built; host seconds) ->
   ``AppleCiderRuntime("configs/fusion.toml")`` ``prepare`` and ``train``
   for 3 epochs of batch 32 in bf16 (K4 forward/backward and K3b launched
   per step, K2 and K3f per validation batch, read from that run alone;
   loss finite, parameters moved, ``best.pt`` and ``last.pt``) -> ``infer``
   (finite (n, 5); kernel path against plain path in f32, TF32 off, <=
   1e-4) -> ``serve`` of every alert of the directories (K1, K2 and K3f
   launched, K1 walking no row; within 1e-6 of ``serve_alert_stream`` run
   directly on a model loaded from ``best.pt`` with the training stats) ->
   ``python -m applecider_tpu_torch.infer.cli`` as a subprocess (exit 0,
   the same alert count) -> ``warmup`` twice (every length bucket x every
   spectra bucket at batch 1024);
7. the photometry model family at the published widths: (a) five MPT and
   five BaselineCLS classifier steps of 256 staged light curves in bf16,
   timed with CUDA events (ms, samples/s, peak GiB), K4 forward and
   backward 4 a step and no other kernel; (b) one f32 MPT step and one
   classifier step (TF32 off, dropout live) on the kernel path and the
   plain path with the same weights, draws and mask, within phase 5's
   limits, and the classifier's eval logits, K2 against plain, within
   1e-4; (c) the reference recipe through the entry points on a learnable
   ``make_corpus`` corpus of 100 objects run through ``preprocess_data``:
   ``AppleCiderRuntime("configs/photometry.toml")`` with ``model.name =
   "MPT"`` for 2 epochs (its loss falls) -> ``warmstart_classifier_params``
   -> the classifier with the trunk frozen for 1 epoch (the trunk
   unmoved, K4's backward still 4 a step) -> unfrozen with plateau 0.5,
   accumulation 2 and EMA 0.99 for 2 epochs (``best.pt``, ``last.pt``) ->
   ``infer`` (finite (n, 5)), K2 4 a validation or inference batch;
8. the spectra and image+metadata families at the published widths: (a)
   five staged bf16 steps each, timed with CUDA events (ms, samples/s,
   peak GiB), of the SpectraNet classifier and redshift regressor (B = 32
   from ``configs/spectra.toml``, L = 3,481; K3f and K3b 5 a step, nothing
   else), of the TriPool classifier (B = 32) and of AstroMiNN (B = 64
   from ``configs/astrominn.toml``), the last two launching no port
   kernel; (b) in f32 (TF32 off, dropout live, the same weights and
   draws) one SpectraNet step on the kernel path against the plain path
   within phase 5's limits and its eval logits within 1e-4, and one
   TriPool step (with the reference's frozen BatchNorm stages) and one
   AstroMiNN step each run twice, equal bit for bit, the BatchNorm
   statistics unmoved; (c) through the entry points:
   ``AppleCiderRuntime("configs/spectra.toml")`` on a learnable table of
   256 spectra for 2 epochs (the loss falls) and as the redshift regressor
   for 1, each then ``infer``; a ``make_corpus`` corpus of 64 learnable
   objects through ``preprocess_data`` and ``build_alert_samples`` (6
   alerts an object at most) into ``configs/astrominn.toml`` for 2
   oversampled epochs and ``infer``; ``configs/fusion.toml`` with the
   TriPool spectra encoder on that corpus for 1 epoch, then ``serve``
   (K1 and K2 launched, no K3f) within 1e-6 of ``serve_alert_stream`` on
   ``best.pt``;
9. deployment, with phase 3's weights: (a) the native decoder over every
   stamp of phase 3b's corpus against ``decode_stamp`` bit for bit, timed
   at 1, 2, 4, 8 and all threads, then ``OverlappedServingFeeder`` in
   thread mode with 1, 2 and 4 workers on records carrying the corpus'
   stamps (alerts/s beside the serial router's), in f32 (TF32 off, within
   1e-6 of the serial router) and bf16 (within 1e-3); (b) ``export_serving`` of
   the bf16 model at every serving length bucket (seconds each, every one
   symbolic in batch, each graph holding K1 x1, K2 x4 and K3f x5 as
   custom-op nodes), then ``engine_serving`` over phase 3b's corpus against
   ``serve_alert_stream`` on the same weights (<= 1e-3; alerts/s of both in
   this call; the launch counters 1/4/5 a program call), and one f32
   program (P = 257, TF32 off) against the live f32 pipeline (<= 1e-5);
   (c) ``export`` of phase 6's trained fusion run in f32 and ``engine``
   against ``infer`` (<= 1e-5) with a ragged tail batch, K2 4 and K3f 5
   launches a batch;
10. one JSON line describing each kernel, then the result line.

It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import shutil
import sys
import time
from pathlib import Path

import numpy as np

from applecider_tpu_torch.tools.kernel_timing import time_ms

REPO = Path(__file__).resolve().parent
# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def no_tf32():
    """f32 products and convolutions in full f32 for a parity check; the
    defaults (TF32 convolutions) come back after it."""
    import torch

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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
    spilled = []
    for name, text in kernel.build_log.items():
        fn, spill = "", ""
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                fn = _short_kernel_name(entry.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                log(f"  nvcc[{name}] {fn}: {line.strip().removeprefix('ptxas info    : ')}; {spill}")
                if fn.startswith("ln_gelu_bwd") and "0 bytes spill stores, 0 bytes spill loads" not in spill:
                    spilled.append(fn)
            elif "error" in line.lower():
                log(f"  nvcc[{name}] {line.strip()}")
    if spilled:  # K3b holds a row in registers: a spill would send it back to memory
        raise SystemExit(f"ptxas spilled registers in K3b: {spilled}")
    build_native_decoder()
    return card


def build_native_decoder() -> None:
    """Build (or load) the native stamp decoder and log its variant."""
    from applecider_tpu_torch import native

    t0 = time.perf_counter()
    variant = native.build_variant()
    log(f"native stamp decoder ({variant} variant) built in {time.perf_counter() - t0:.1f} s: "
        f"{native.get_lib()._name}")


def _short_kernel_name(mangled: str) -> str:
    """A kernel's mangled name without its namespace and parameter list,
    e.g. ``flash_bwd_mma_kernelILi16ELi1`` for flash_bwd_mma_kernel<16, 1>."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+(.*?)E+v", mangled)
    return m.group(1) if m else mangled


# ------------------------------------------------------------- phase 2
# K1's cases: (kind, B, P). The serving layout at every serving length, at
# warp edges and at the longest row with a thread a step (1024); P = 1025
# and 5000 are longer, so every row of them is walked; B = 1 and 513; then
# every kind of row that the parallel path must refuse or must take exactly.
K1_BUCKETS = (63, 127, 191, 255, 257)  # infer.stream.LENGTH_BUCKETS
K1_STAGED_MAX_P = 1024  # longest row that K1 gives a thread a step
K1_CASES = ([("serving", 513, P) for P in (1, 31, 32, 33, *K1_BUCKETS, 1024, 1025, 5000)]
            + [("serving", 1, P) for P in (1, 33, 257, 5000)]
            + [(kind, 513, P) for kind in ("one_group", "singletons", "shuffled", "nan", "holes_inf",
                                           "holes_finite") for P in (33, 257)])


def _merge_inputs(rng, B, P, dev, kind="serving"):
    """K1's inputs: the serving layout (``tools/kernel_timing.serving_rows``),
    or one kind of row throughout: one group a band, a group a point, not
    time-ascending, NaN and -inf times, holes holding +inf or finite times."""
    import torch

    from applecider_tpu_torch.tools.kernel_timing import serving_rows

    if kind == "serving":
        return serving_rows(rng, B, P, dev)
    t = np.sort(rng.uniform(0, 30, (B, P)), axis=1)
    valid = np.arange(P)[None, :] < rng.integers(0, P + 1, B)[:, None]
    if kind == "one_group":  # each band's points within dt of its first
        t = np.sort(rng.uniform(0, 0.5, (B, P)), axis=1).astype(np.float32)
        t[:, -1] = t[:, 0] + np.float32(0.5)
        valid[:] = True
    elif kind == "singletons":  # 0.75 between points: every point a group
        t = np.broadcast_to(np.arange(P, dtype=np.float32) * 0.75, (B, P))
        valid[:] = True
    elif kind == "shuffled":
        t = rng.permuted(t, axis=1)
    elif kind == "nan":
        bad = rng.random((B, P)) < 0.15
        bad[: B // 2, 0] = True
        t = np.where(bad, np.where(rng.random((B, P)) < 0.5, np.nan, -np.inf), t)
    elif kind in ("holes_inf", "holes_finite"):
        valid = rng.random((B, P)) < 0.6
    hole = rng.uniform(0, 30, (B, P)) if kind == "holes_finite" else np.inf
    t = np.where(valid, t, hole).astype(np.float32)
    band = rng.integers(0, 3, (B, P)).astype(np.int32)
    return (torch.from_numpy(t).to(dev), torch.from_numpy(band).to(dev),
            torch.from_numpy(valid).to(dev))


def _k1_walks(t, band, valid) -> int:
    """Rows that K1 must walk with the recurrence: all when P is longer than
    a block's 1024 threads, else those where some band's valid times are
    not non-decreasing or hold a NaN or -inf."""
    t, band, valid = (x.cpu().numpy() for x in (t, band, valid))
    B, P = t.shape
    if P > K1_STAGED_MAX_P:
        return B
    walks = 0
    for r in range(B):
        for k in range(3):
            x = t[r][valid[r] & (band[r] == k)]
            if not (np.all(x > -np.inf) and np.all(x[:-1] <= x[1:])):
                walks += 1
                break
    return walks


def check_merge_scan(rng, dev) -> dict:
    """K1 exactly equal to its plain version, twice bit for bit, with the
    count of walked rows each case must give: on every case of ``K1_CASES``
    (after the two B = 1024 serving cases drawn from ``rng``, as before, so
    that the other kernels' inputs stay as they were), then on the inputs
    it is timed on: B = 1024 P = 257 and B = 512 at each serving length, as
    every kernel (``ms``) and with the calls queued behind a sleep
    (``device_ms``)."""
    import torch

    from applecider_tpu_torch.ops import merge_scan as ms
    from applecider_tpu_torch.tools.kernel_timing import time_k1

    walked = ms.walked_rows(dev)

    def check(kind, t, band, valid) -> int:
        B, P = t.shape
        walked.zero_()
        got = ms.seg_ids(t, band, valid, 0.5)
        n_walked = int(walked.item())
        again = ms.seg_ids(t, band, valid, 0.5)
        want = ms.seg_ids_reference(t, band, valid, 0.5)
        err = int((got - want).abs().max().item())
        expect = _k1_walks(t, band, valid)
        same = torch.equal(got, again)
        ok = err == 0 and same and n_walked == expect
        log(f"K1 merge_scan {kind} B={B} P={P}: max|d|={err} (exact required), two launches "
            f"{'equal' if same else 'DIFFER'}, rows walked {n_walked} "
            f"(expected {expect}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"K1 fails on {kind} B={B} P={P}")
        return err

    errs = [check("serving", *_merge_inputs(rng, 1024, P, dev)) for P in (63, 257)]
    crng = np.random.default_rng(8)
    errs += [check(kind, *_merge_inputs(crng, B, P, dev, kind)) for kind, B, P in K1_CASES]
    timed = time_k1(dev, check=lambda *x: errs.append(check("timed serving", *x)))
    for r in timed:
        r["bound_ms"] = bound_ms(r["B"] * r["P"] * (4 + 4 + 1 + 4), 0.0, "float32")[0]
        log(f"K1 merge_scan timed B={r['B']} P={r['P']}: kernel {r['ms']:.4f} ms, device alone "
            f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms (bytes)"
            + (f", plain {r['plain_ms']:.4f} ms, library none" if "plain_ms" in r else ""))
    main = timed[0]
    return dict(name="merge_scan", route="cuda", source="applecider_tpu_torch/csrc/merge_scan.cu",
                replaces="applecider_tpu/ops/merge_scan.py:48", shape=f"B={main['B']} P={main['P']}",
                dtype="float32", max_abs_err=float(max(errs)), ms=main["ms"],
                device_ms=main["device_ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by="bytes", library_ms=None, buckets=timed[1:])


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


# train shape of the photometry attention: B = 256, 8 heads, L = 257 + CLS
TRAIN_B, HEADS, TRAIN_L, HEAD_DIM, RATE = 256, 8, 258, 16, 0.40


def _attn_inputs(rng, B, L, dtype, dev, H=HEADS, hd=HEAD_DIM):
    import torch

    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, L, hd)).astype(np.float32)).to(dev, dtype)
                   for _ in range(4))
    lengths = rng.integers(1, L + 1, B)
    mask = torch.from_numpy(np.arange(L)[None, :] >= lengths[:, None]).to(dev)
    return q, k, v, do, mask


# (B, L, hd) of the K2 checks: 16-row tile tails (L = 1, 17, 33), every
# length the serving path gives it (L = P + 1 for its length buckets P, the
# CLS token added) at the serving batch, and hd 8 (one k16 step, half
# padding) and 32 (two k16 steps) at a tail and at L = 258
SERVING_LENGTHS = tuple(P + 1 for P in (63, 127, 191, 255, 257))  # infer/stream.LENGTH_BUCKETS
ATTN_CASES = (tuple((64, L, HEAD_DIM) for L in (1, 17, 33))
              + tuple((512, L, HEAD_DIM) for L in SERVING_LENGTHS)
              + tuple((64, L, hd) for hd in (8, 32) for L in (17, TRAIN_L)))
# (B, L) of K2's timed rows: the train shape, and the serving batch at its
# longest full bucket (P = 255)
ATTN_TIMED = ((256, 258), (512, 256))


def check_attention(rng, dev) -> dict:
    """K2 against its plain version at ``ATTN_CASES`` in f32 (<= 1e-5) and
    bf16 (<= 2e-2 * max(1, |plain|)), batch row 0 with every key masked
    (the plain version's uniform softmax); then timed at ``ATTN_TIMED``
    beside the plain version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F

    from applecider_tpu_torch.ops import attention as at

    for B, L, hd in ATTN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, mask = _attn_inputs(rng, B, L, dtype, dev, hd=hd)
            mask[0] = True
            err, ok = _tol_ok(at.masked_attention(q, k, v, mask), at.masked_attention_reference(q, k, v, mask),
                              dtype)
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            rule = "<= 1e-5" if dtype == torch.float32 else "<= 2e-2*max(1,|plain|)"
            log(f"K2 attention B={B} H={HEADS} L={L} hd={hd} {dname}, batch row 0 fully masked: "
                f"max|d|={err:.3g} ({rule}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version at L={L} hd={hd} {dname}")
            del q, k, v, mask
    rows = {}
    for B, L in ATTN_TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, _, mask = _attn_inputs(rng, B, L, dtype, dev)
            got = at.masked_attention(q, k, v, mask)
            want = at.masked_attention_reference(q, k, v, mask)
            err, ok = _tol_ok(got, want, dtype)
            ms_k = time_ms(lambda: at.masked_attention(q, k, v, mask))
            ms_p = time_ms(lambda: at.masked_attention_reference(q, k, v, mask))
            keep = ~mask[:, None, None, :]
            ms_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep))
            nbytes = 4 * B * HEADS * L * HEAD_DIM * q.element_size() + B * L
            dname = "float32" if dtype == torch.float32 else "bfloat16"
            b_ms, b_by = bound_ms(nbytes, 4.0 * B * HEADS * L * L * HEAD_DIM, dname)
            log(f"K2 attention B={B} H={HEADS} L={L} hd={HEAD_DIM} {dname}: max|d|={err:.3g} "
                f"kernel {ms_k:.4f} ms plain {ms_p:.4f} ms sdpa {ms_l:.4f} ms (kernel/sdpa {ms_k / ms_l:.2f}) "
                f"bound {b_ms:.5f} ms ({b_by}) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"K2 disagrees with its plain version at B={B} L={L} {dname}")
            if dtype == torch.bfloat16:
                rows[B, L] = dict(shape=f"B={B} H={HEADS} L={L} hd={HEAD_DIM}", max_abs_err=err, ms=ms_k,
                                  plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by, library_ms=ms_l)
            del q, k, v, mask, got, want
    rec = dict(name="masked_attention", route="cuda", source="applecider_tpu_torch/csrc/attention.cu",
               replaces="applecider_tpu/ops/attention.py:35", dtype="bfloat16", **rows[ATTN_TIMED[0]])
    rec["at_serving_shape"] = rows[ATTN_TIMED[1]]
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


def _rel_ok(got, want, rel: float) -> tuple[float, bool]:
    """max |got - want| and whether it is <= rel * max(1, |want|) everywhere."""
    import torch

    d = (got.float() - want.float()).abs()
    err = float(d.max().item()) if d.numel() else 0.0
    return err, bool((d <= rel * torch.clamp(want.float().abs(), min=1.0)).all().item())


# (B, L, hd) of the K4b checks: the train head width at tile tails (L = 1,
# 17, 33: one or two rows past a 16-row tile) and full tiles; hd 8 (one
# k16 step, half padding) and 32 (two k16 steps) at a tail and at L = 258
FLASH_BITS_CASES = tuple((64, L, HEAD_DIM) for L in (1, 17, 33, 64, TRAIN_L)) + tuple(
    (8, L, hd) for hd in (8, 32) for L in (17, TRAIN_L))


def check_flash_bits(rng, dev) -> None:
    """K4b: forward and backward on random u8 bits, kernel vs plain twin, at
    ``FLASH_BITS_CASES``. f32: out <= 1e-5 abs, dq/dk/dv <= 1e-4 * max(1,
    |g|) (the backward sums up to 258 products in another order). bf16:
    <= 2e-2 * max(1, |plain|): both versions round the same f32
    intermediates (P, pd, ds) to bf16, and values whose f32 results differ
    in the last bits may land one bf16 step (2^-8 relative) apart. Batch row
    0 has every key masked: its rows take the uniform softmax of the plain
    version (all scores -1e9)."""
    import torch

    from applecider_tpu_torch.ops import flash_attention as fa

    thresh, _ = fa._drop_consts(RATE)
    for B, L, hd in FLASH_BITS_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, mask = _attn_inputs(rng, B, L, dtype, dev, hd=hd)
            mask[0] = True
            bits = torch.from_numpy(rng.integers(0, 256, (B, HEADS, L, L), dtype=np.uint8)).to(dev)
            keep = bits >= thresh
            out = fa.flash_forward(q, k, v, mask, RATE, bits=bits)
            want = fa.flash_attention_reference(q, k, v, mask, keep, RATE)
            grads = fa.flash_backward(q, k, v, mask, RATE, do, bits=bits)
            wgrads = fa.flash_attention_backward_reference(q, k, v, mask, keep, RATE, do)
            torch.cuda.synchronize()
            f32 = dtype == torch.float32
            e_out, ok_out = _tol_ok(out, want, dtype) if f32 else _rel_ok(out, want, 2e-2)
            e_g, ok_g = 0.0, True
            for g, w in zip(grads, wgrads):
                e, ok = _rel_ok(g, w, 1e-4 if f32 else 2e-2)
                e_g, ok_g = max(e_g, e), ok_g and ok
            dname = "float32" if f32 else "bfloat16"
            log(f"K4b flash bits B={B} H={HEADS} L={L} hd={hd} {dname}: fwd max|d|={e_out:.3g} "
                f"bwd max|d|={e_g:.3g} ({'<= 1e-5 / 1e-4*max(1,|g|)' if f32 else '<= 2e-2*max(1,|plain|)'}) "
                f"{'OK' if ok_out and ok_g else 'FAIL'}")
            if not (ok_out and ok_g):
                raise SystemExit(f"K4b disagrees with its plain version at L={L} hd={hd} {dname}")
            del q, k, v, do, bits, keep, out, want, grads, wgrads


# (B, L, hd) of the Philox replay checks: the train length; L = 1; two
# lengths whose L^2 is not a multiple of 4, so that a 16-row tile's first
# element falls inside a Philox counter and the fill starts mid-counter;
# and hd 8 and 32 at a tail and at the train length
FLASH_PRNG_CASES = ((64, TRAIN_L, HEAD_DIM), (8, 1, HEAD_DIM), (8, 17, HEAD_DIM), (8, 33, HEAD_DIM)) + tuple(
    (8, L, hd) for hd in (8, 32) for L in (17, TRAIN_L))


def check_flash_prng(rng, dev) -> dict:
    """K4a: the exported keep mask equals the Philox twin's draws >= thresh
    exactly; the Philox forward and backward equal the bits kernels fed
    keep * 255 exactly, at ``FLASH_PRNG_CASES``; at rate 0 the exported mask
    keeps everything and the output equals the plain forward's; the keep
    rate over the train shape; two seeds."""
    import torch

    from applecider_tpu_torch.ops import flash_attention as fa

    thresh, _ = fa._drop_consts(RATE)
    seed = 20260101
    for B, L, hd in FLASH_PRNG_CASES:
        q, k, v, do, mask = _attn_inputs(rng, B, L, torch.bfloat16, dev, hd=hd)
        out0, keep0 = fa.flash_attention_export_mask(q, k, v, mask, seed, 0.0)
        e0, ok0 = _rel_ok(out0, fa.flash_attention_reference(q, k, v, mask, None, 0.0), 2e-2)
        if not (ok0 and bool(keep0.all())):
            raise SystemExit(f"K4a's rate-0 export at L={L} hd={hd}: out max|d|={e0:.3g}, "
                             f"{int((keep0 == 0).sum())} entries not kept")
        out, keep = fa.flash_attention_export_mask(q, k, v, mask, seed, RATE)
        want_keep = (fa.dropout_bits_reference(seed, B, HEADS, L, device=dev) >= thresh).to(torch.uint8)
        mism = int((keep != want_keep).sum().item())
        out_p = fa.flash_forward(q, k, v, mask, RATE, seed=seed)
        out_b = fa.flash_forward(q, k, v, mask, RATE, bits=keep * 255)
        g_p = fa.flash_backward(q, k, v, mask, RATE, do, seed=seed)
        g_b = fa.flash_backward(q, k, v, mask, RATE, do, bits=keep * 255)
        d_fwd = max(float((out_p.float() - out_b.float()).abs().max()),
                    float((out.float() - out_b.float()).abs().max()))
        d_bwd = max(float((a.float() - b.float()).abs().max()) for a, b in zip(g_p, g_b))
        log(f"K4a Philox keep mask vs dropout_bits_reference, B={B} L={L} hd={hd}: {mism} of "
            f"{keep.numel()} differ (0 required); replay through the bits kernels: fwd max|d|={d_fwd} "
            f"bwd max|d|={d_bwd} (0 required); rate-0 export all kept, out max|d|={e0:.3g}")
        if mism or d_fwd or d_bwd:
            raise SystemExit(f"K4a disagrees with its Philox twin or with the bits kernels at L={L} hd={hd}")
        del q, k, v, do, mask, out, keep, want_keep, out_p, out_b, g_p, g_b, out0, keep0
    q, k, v, do, mask = _attn_inputs(rng, TRAIN_B, TRAIN_L, torch.bfloat16, dev)
    _, keep = fa.flash_attention_export_mask(q, k, v, mask, seed, RATE)
    frac = float(keep.float().mean())
    _, keep2 = fa.flash_attention_export_mask(q, k, v, mask, seed + 1, RATE)
    differ = float((keep != keep2).float().mean())
    want = (256 - thresh) / 256
    log(f"K4a keep fraction over {keep.numel()} draws: {frac:.6f} (want {want:.6f} within 1e-3); "
        f"share of draws that differ between two seeds: {differ:.4f}")
    if abs(frac - want) > 1e-3 or differ < 0.3:
        raise SystemExit("K4a keep rate off, or two seeds drew the same mask")
    return {"keep_fraction": frac, "seed_differ": differ}


# K4a's bf16 backward before it moved to the tensor cores (chip_smoke,
# NVIDIA H100 80GB HBM3 at 700 W), for the log line only
FLASH_BWD_EARLIER_MS = 5.3990


def time_flash(rng, dev) -> tuple[dict, dict]:
    """K4 forward and backward at the train shape in bf16 (Philox): each
    held against its plain twin on the same inputs (<= 2e-2 * max(1,
    |plain|)), then timed beside the twin, SDPA with dropout 0.4 as the
    library yardstick, and the bounds; both also at rate 0 (keep-all: no
    draw, no keep bytes), held against the plain versions with every key
    kept, so that Philox - keep-all is what the dropout costs inside each."""
    import torch
    import torch.nn.functional as F

    from applecider_tpu_torch.ops import flash_attention as fa

    B, H, L, hd = TRAIN_B, HEADS, TRAIN_L, HEAD_DIM
    thresh, _ = fa._drop_consts(RATE)
    q, k, v, do, mask = _attn_inputs(rng, B, L, torch.bfloat16, dev)
    seed = 7
    ms_f = time_ms(lambda: fa.flash_forward(q, k, v, mask, RATE, seed=seed))
    ms_f0 = time_ms(lambda: fa.flash_forward(q, k, v, mask, 0.0))
    ms_b = time_ms(lambda: fa.flash_backward(q, k, v, mask, RATE, do, seed=seed))
    ms_b0 = time_ms(lambda: fa.flash_backward(q, k, v, mask, 0.0, do, seed=seed))

    def plain_fwd():
        keep = fa.dropout_bits_reference(seed, B, H, L, device=dev) >= thresh
        return fa.flash_attention_reference(q, k, v, mask, keep, RATE)

    def plain_bwd():
        keep = fa.dropout_bits_reference(seed, B, H, L, device=dev) >= thresh
        return fa.flash_attention_backward_reference(q, k, v, mask, keep, RATE, do)

    e_f, ok_f = _rel_ok(fa.flash_forward(q, k, v, mask, RATE, seed=seed), plain_fwd(), 2e-2)
    e_f0, ok_f0 = _rel_ok(fa.flash_forward(q, k, v, mask, 0.0),
                          fa.flash_attention_reference(q, k, v, mask, None, 0.0), 2e-2)
    ok_f = ok_f and ok_f0
    e_b = e_b0 = 0.0
    ok_b = ok_b0 = True
    for g, w in zip(fa.flash_backward(q, k, v, mask, RATE, do, seed=seed), plain_bwd()):
        e, ok = _rel_ok(g, w, 2e-2)
        e_b, ok_b = max(e_b, e), ok_b and ok
    for g, w in zip(fa.flash_backward(q, k, v, mask, 0.0, do, seed=seed),
                    fa.flash_attention_backward_reference(q, k, v, mask, None, 0.0, do)):
        e, ok = _rel_ok(g, w, 2e-2)
        e_b0, ok_b0 = max(e_b0, e), ok_b0 and ok
    log(f"K4a {B=} {H=} {L=} {hd=} bf16 vs plain (<= 2e-2*max(1,|plain|)): fwd max|d|={e_f:.3g}, "
        f"fwd at rate 0 max|d|={e_f0:.3g}, bwd max|d|={e_b:.3g}, bwd at rate 0 max|d|={e_b0:.3g} "
        f"{'OK' if ok_f and ok_b and ok_b0 else 'FAIL'}")
    if not (ok_f and ok_b and ok_b0):
        raise SystemExit("K4a disagrees with its plain version at the train shape")
    ms_pf = time_ms(plain_fwd, iters=2, reps=3)
    ms_pb = time_ms(plain_bwd, iters=2, reps=3)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attend = ~mask[:, None, None, :]
    lib_out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attend, dropout_p=RATE)
    ms_lf = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attend,
                                                           dropout_p=RATE))
    ms_lb = time_ms(lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do, retain_graph=True))
    io = B * H * L * hd * 2
    fb, fby = bound_ms(4 * io + B * L, 4.0 * B * H * L * L * hd, "bfloat16")
    bb, bby = bound_ms(7 * io + B * L, 10.0 * B * H * L * L * hd, "bfloat16")
    shape = f"B={B} H={H} L={L} hd={hd} rate={RATE}"
    log(f"K4a fwd {shape} bf16: kernel {ms_f:.4f} ms, plain {ms_pf:.4f} ms, "
        f"sdpa(dropout) {ms_lf:.4f} ms (kernel/sdpa {ms_f / ms_lf:.2f}), bound {fb:.5f} ms ({fby}); "
        f"at rate 0 (keep-all) {ms_f0:.4f} ms: Philox costs {ms_f - ms_f0:.4f} ms more")
    log(f"K4a bwd {shape} bf16: kernel {ms_b:.4f} ms (earlier {FLASH_BWD_EARLIER_MS:.4f}), "
        f"plain {ms_pb:.4f} ms, sdpa(dropout) backward {ms_lb:.4f} ms, bound {bb:.5f} ms ({bby}); "
        f"at rate 0 (keep-all) {ms_b0:.4f} ms: Philox costs {ms_b - ms_b0:.4f} ms more")

    # K4b: the same kernels reading injected bits, (B, H, L, L) u8 more to read
    gen = torch.Generator(device=dev).manual_seed(5)
    bits = torch.randint(0, 256, (B, H, L, L), dtype=torch.uint8, device=dev, generator=gen)
    keep = bits >= thresh
    ms_fbits = time_ms(lambda: fa.flash_forward(q, k, v, mask, RATE, bits=bits))
    ms_bbits = time_ms(lambda: fa.flash_backward(q, k, v, mask, RATE, do, bits=bits))
    ms_pfbits = time_ms(lambda: fa.flash_attention_reference(q, k, v, mask, keep, RATE),
                        iters=2, reps=3)
    ms_pbbits = time_ms(lambda: fa.flash_attention_backward_reference(q, k, v, mask, keep, RATE, do),
                        iters=2, reps=3)
    fbb, fbby = bound_ms(4 * io + B * L + bits.numel(), 4.0 * B * H * L * L * hd, "bfloat16")
    bbb, bbby = bound_ms(7 * io + B * L + bits.numel(), 10.0 * B * H * L * L * hd, "bfloat16")
    log(f"K4b fwd {shape} bf16, injected bits: kernel {ms_fbits:.4f} ms, plain {ms_pfbits:.4f} ms, "
        f"bound {fbb:.5f} ms ({fbby}), library none")
    log(f"K4b bwd {shape} bf16, injected bits: kernel {ms_bbits:.4f} ms, plain {ms_pbbits:.4f} ms, "
        f"bound {bbb:.5f} ms ({bbby}), library none")
    del bits, keep
    common = dict(route="cuda", source="applecider_tpu_torch/csrc/flash_attention.cu", shape=shape,
                  dtype="bfloat16")
    fwd = dict(name="flash_attention_fwd", replaces="applecider_tpu/ops/flash_attention.py:162",
               max_abs_err=e_f, ms=ms_f, keep_all_ms=ms_f0, plain_ms=ms_pf, bound_ms=fb, bound_by=fby,
               library_ms=ms_lf, **common)
    bwd = dict(name="flash_attention_bwd", replaces="applecider_tpu/ops/flash_attention.py:200",
               max_abs_err=e_b, ms=ms_b, keep_all_ms=ms_b0, plain_ms=ms_pb,
               bound_ms=bb, bound_by=bby, library_ms=ms_lb, **common)
    return fwd, bwd


# (case, B, L, hd) of the K4x checks: prefix masks at the 16-row tile tails
# the tensor-core rungs must get right (L = 1, 17, 33) and at full tiles,
# hd 8 and 32 at a tail and at L = 258; no padded key, where matmul_only's
# limit is tight; and the ladder's own inputs, the shape and mask the timed
# path gives the kernels
LADDER_CASES = (tuple(("prefix masks", 64, L, HEAD_DIM) for L in (1, 17, 33, 64, TRAIN_L))
                + tuple(("prefix masks", 8, L, hd) for hd in (8, 32) for L in (17, TRAIN_L))
                + (("no padded key", 64, TRAIN_L, HEAD_DIM), ("ladder inputs", 256, TRAIN_L, HEAD_DIM)))


def _pairs_refused(L: int, hd: int, n: int, f32: bool, dev) -> bool:
    """Whether ``batched{n}``'s shared memory is over a block's opt-in limit,
    so that its launch must be refused: ``pairs_smem`` (f32: the mask, 8
    warps' score rows, K and V of n heads in rows of hd + 1 words) and
    ``pairs_mma_smem`` (bf16: K and V of n heads as (Lp, max(16, hd)), the
    mask) of ``csrc/flash_attention.cu``."""
    import torch

    if f32:
        smem = 4 * (L + 8 * L) + 2 * 4 * n * L * (hd + 1)
    else:
        Lp = 16 * -(-L // 16)
        smem = 2 * 2 * n * Lp * max(16, hd) + 4 * Lp
    return smem > torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _matmul_only_flips(q, k, v, mask):
    """The bf16 ``matmul_only`` kernel's raw scores against the plain
    version's: (D, flips, stray). The kernel's bf16 scores are read back
    through the rung itself, with one-hot V (each output then holds one
    score times 1, exactly). flips counts the scores that round to another
    bf16 value than the plain version's, whose f32 sums run in another
    order; D = sum_j |kernel_j - plain_j| |v_j|, their exact effect on the
    output, which ``matmul_only`` never normalises. stray counts the flips
    that no two f32 evaluations of the score could give: more than one bf16
    step, or at a score whose plain f32 value lies farther than
    2 hd 2^-23 sum_e |q_e k_e| (twice the error bound of an hd-term f32 dot
    product, in any order, rounding to nearest or truncating) from a bf16
    rounding midpoint."""
    import torch

    from applecider_tpu_torch.ops import flash_attention as fa
    from applecider_tpu_torch.ops import flash_microab as fm

    B, H, L, hd = q.shape
    cols = []
    for j0 in range(0, L, hd):
        keys = torch.arange(j0, min(j0 + hd, L), device=q.device)
        onehot = torch.zeros_like(v)
        onehot[:, :, keys, keys - j0] = 1
        cols.append(fm.flash_forward_ablation(q, k, onehot, mask, "matmul_only")[..., :len(keys)].float())
    scores = fa._scores(q, k, mask)
    gap = (torch.cat(cols, dim=-1) - scores.to(q.dtype).float()).abs()
    del cols
    qs = (q.float() * (1.0 / hd ** 0.5)).to(q.dtype).float()
    w = 2 * hd * 2.0 ** -23 * torch.matmul(qs.abs(), k.float().abs().transpose(-1, -2))
    step = ((scores + w).to(q.dtype).float() - (scores - w).to(q.dtype).float()).abs()
    flips = int((gap > 0).sum())
    stray = int((gap > step).sum())
    return torch.matmul(gap, v.float().abs()), flips, stray


def check_flash_ladder(rng, dev) -> dict:
    """K4x: every rung of the forward ablation ladder against its plain
    version, in f32 and bf16, at ``LADDER_CASES`` (the ladder's own inputs
    are ``tools/flash_microab.make_inputs``: B = 256, L = 258, a random key
    mask U < 0.2, its seed). f32 <= 1e-5 abs and bf16 <= 2e-2 * max(1,
    |plain|), as K4. ``matmul_only`` sums terms of order 1e9 that cancel
    where a key is padded, so its f32 rounding error scales with M = sum_j
    |p_j||v_j| (``matmul_only_magnitude``), not with |out|: f32 <= 1e-6 *
    max(1, M), bf16 <= 2e-2 * max(1, |plain|) + 1e-6 * M + D, where D is
    the exact effect of the raw scores that the tensor cores' f32 sums round
    to the other bf16 neighbour (``_matmul_only_flips``: 0 at all but a few
    outputs), each of which must be a rounding tie that two f32 orders can
    split; without a padded key M is O(100) and the limit tight. In both
    dtypes each rung is an instantiation of K4a's forward (bf16: the
    tensor-core kernel), so at max |d| = 0: ``full`` equals
    ``flash_forward(seed=)``, ``no_prng``
    ``flash_forward`` at rate 0, and ``prng_only_no_apply`` and
    ``batched4/8`` the ``no_prng`` kernel. A ``batched{N}`` whose K and V
    do not fit a block's shared memory (f32 at L = 258, hd >= 16; hd = 32
    with N = 8) must be refused at launch. Returns max |d| per rung on the
    ladder's own inputs in bf16."""
    import torch

    from applecider_tpu_torch.ops import flash_attention as fa
    from applecider_tpu_torch.ops import flash_microab as fm
    from applecider_tpu_torch.tools import flash_microab as tool

    errs = {}
    for case, B, L, hd in LADDER_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            dname = "float32" if f32 else "bfloat16"
            seed = 20260102
            if case == "ladder inputs":
                q, k, v, mask = tool.make_inputs(dtype, dev)
                seed = tool.SEED
            else:
                q, k, v, _, mask = _attn_inputs(rng, B, L, dtype, dev, hd=hd)
                if case == "no padded key":
                    mask = torch.zeros_like(mask)
            tag = f"K4x {case}, B={B} H={HEADS} L={L} hd={hd} {dname}"
            outs = {}
            for mode in fm.MODES:
                n = fm.pair_block(mode)
                if n and _pairs_refused(L, hd, n, f32, dev):
                    try:
                        fm.flash_forward_ablation(q, k, v, mask, mode, RATE, seed)
                    except RuntimeError as err:
                        log(f"{tag} {mode}: refused, as it must be ({err})")
                        continue
                    raise SystemExit(f"{tag} {mode} ran past a block's shared memory")
                got = outs[mode] = fm.flash_forward_ablation(q, k, v, mask, mode, RATE, seed)
                want = fm.flash_forward_ablation_reference(q, k, v, mask, mode, RATE, seed)
                note = ""
                if mode == "matmul_only":
                    mag = fm.matmul_only_magnitude(q, k, v, mask)
                    d = (got.float() - want.float()).abs()
                    lim = 1e-6 * (mag.clamp(min=1.0) if f32 else mag)
                    note = f", max M={float(mag.max()):.3g}"
                    stray = 0
                    if not f32:
                        flip_d, flips, stray = _matmul_only_flips(q, k, v, mask)
                        lim = lim + 2e-2 * want.float().abs().clamp(min=1.0) + flip_d
                        note += (f"; {flips} of {q.numel() // hd * L} scores "
                                 f"round to the other bf16 neighbour, {stray} of them not at a tie (0 required), "
                                 f"D > 0 at {int((flip_d > 0).sum())} of {flip_d.numel()} outputs, "
                                 f"max D={float(flip_d.max()):.3g}")
                        del flip_d
                    err, ok = float(d.max()), bool((d <= lim).all()) and stray == 0
                    rule = "<= 1e-6*max(1,M)" if f32 else "<= 2e-2*max(1,|plain|) + 1e-6*M + D"
                    del mag, d, lim
                else:
                    err, ok = _tol_ok(got, want, dtype) if f32 else _rel_ok(got, want, 2e-2)
                    rule = "<= 1e-5" if f32 else "<= 2e-2*max(1,|plain|)"
                log(f"{tag} {mode}: max|d|={err:.3g} ({rule}{note}) {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{tag}: {mode} disagrees with its plain version")
                if case == "ladder inputs" and not f32:
                    errs[mode] = err
                del want

            def diff(a, b):
                return float((a.float() - b.float()).abs().max())

            d_full = diff(outs["full"], fa.flash_forward(q, k, v, mask, RATE, seed=seed))
            d_keep_all = diff(outs["no_prng"], fa.flash_forward(q, k, v, mask, 0.0))
            d_same = {m: diff(outs[m], outs["no_prng"]) for m in outs
                      if m == "prng_only_no_apply" or m.startswith("batched")}
            log(f"{tag}: full vs flash_forward(seed) max|d|={d_full}, no_prng vs flash_forward at rate 0 "
                f"max|d|={d_keep_all}, vs the no_prng kernel max|d| {d_same} (0 required for each)")
            if d_full or d_keep_all or any(d_same.values()):
                raise SystemExit(f"{tag}: a rung differs from the K4a forward it instantiates, or from no_prng")
            del q, k, v, mask, outs
    return errs


def _sass(source: str) -> str:
    """``cuobjdump -sass`` of the built library of ``csrc/<source>.cu``."""
    import os
    import subprocess

    from applecider_tpu_torch.ops import kernel

    cuobjdump = os.path.join(os.path.dirname(kernel._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(kernel._library_path(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout


def _sass_functions(source: str):
    """(mangled name, SASS body) of every kernel in ``source``'s library."""
    return re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", _sass(source), re.S)


def check_draw_in_sass() -> None:
    """K4x's ``prng_only_no_apply`` must keep the Philox draw that its output
    never uses. In the SASS of the bf16 tensor-core forward at hd = 16
    (``cuobjdump -sass`` of ``flash_fwd_mma_kernel<16, MODE>``), the lines
    that use a Philox multiplier (0xD2511F53, 0xCD9E8D57, which SASS may
    print as the signed immediates -0x2daee0ad, -0x326172a9) must be there
    in kDrawOnly (3) and kPhilox (1), and absent from kKeepAll (0), which
    draws nothing."""
    multipliers = ("0xd2511f53", "0xcd9e8d57", "-0x2daee0ad", "-0x326172a9")
    lines = {}
    for name, body in _sass_functions("flash_attention"):
        m = re.search(r"flash_fwd_mma_kernelILi16ELi(\d)E", name)
        if m:
            lines[int(m.group(1))] = sum(any(c in ln for c in multipliers)
                                         for ln in body.lower().splitlines())
    keep_all, philox, draw = lines.get(0), lines.get(1), lines.get(3)
    log(f"K4x SASS lines using a Philox multiplier, flash_fwd_mma_kernel<16, MODE>: kKeepAll {keep_all}, "
        f"kPhilox {philox}, kDrawOnly {draw} (kDrawOnly and kPhilox > 0, kKeepAll 0 required)")
    if not (draw and philox and keep_all == 0):
        raise SystemExit("K4x prng_only_no_apply lost its Philox draw, or the SASS was not found")


# the tensor-core kernels and the number of their instantiations: K2 (3
# head widths); K4's forward (3 head widths x 5 modes: the 3 keep sources
# and the K4x ladder's draw-only and matmul-only) and backward (3 x 3); the
# ladder's batched kernel (3)
TENSOR_CORE_KERNELS = {"mha_mma_kernel": 3, "flash_fwd_mma_kernel": 15, "flash_bwd_mma_kernel": 9,
                       "flash_fwd_mma_pairs_kernel": 3}
# the FMA kernels, all f32: K2; K4's forward (the same 5 modes) and
# backward; the ladder's batched kernel
FMA_KERNELS = {"mha_kernelIf": 3, "flash_fwd_kernelIf": 15, "flash_bwd_kernelIf": 9, "flash_fwd_pairs_kernelIf": 3}


def check_tensor_cores() -> None:
    """The bf16 attention kernels run their products on the tensor cores and
    the FMA kernels do not: in the SASS (``cuobjdump -sass``) of the
    attention and flash_attention libraries, every instantiation of the
    tensor-core kernels (bf16 K2, K4's forward with the K4x rungs, K4's
    backward, K4x's batched kernel) must hold HMMA instructions, and none
    of the FMA kernels' (all f32) any; no other kernel, such as a bf16
    instantiation of an FMA kernel, may be in the libraries."""
    hmma = {}
    for source in ("attention", "flash_attention"):
        for name, body in _sass_functions(source):
            m = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernelI(?:f|13__nv_bfloat16)?)(Li\d+E(?:Li\d+E)*)", name)
            if m:
                args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
                hmma.setdefault(m.group(1), {})[args] = len(re.findall(r"\bHMMA\.", body))
    tc = {n: hmma.get(n + "I", {}) for n in TENSOR_CORE_KERNELS}
    fma = {n: hmma.get(n, {}) for n in FMA_KERNELS}
    other = sorted(set(hmma) - {n + "I" for n in TENSOR_CORE_KERNELS} - set(FMA_KERNELS))
    log(f"SASS HMMA instructions per instantiation (hd, keep mode): tensor-core kernels {tc}; "
        f"FMA kernels {fma}; other kernels {other} (> 0 in every tensor-core and 0 in every FMA "
        f"instantiation, and no other kernel, required)")
    counts_ok = all(len(tc[n]) == c for n, c in TENSOR_CORE_KERNELS.items()) and all(
        len(fma[n]) == c for n, c in FMA_KERNELS.items())
    if not counts_ok or other or not all(all(v.values()) for v in tc.values()) or any(
            any(v.values()) for v in fma.values()):
        raise SystemExit("a bf16 attention kernel left the tensor cores, an FMA kernel moved onto them, "
                         "an instantiation is missing, or a kernel is unaccounted for")


# K4x's bf16 rungs when they ran on the FMA kernel, before they moved onto
# the tensor-core forward (chip_smoke, NVIDIA H100 80GB HBM3 at 700 W), for
# the log lines only
LADDER_FMA_EARLIER_MS = {"full": 1.3981, "prng_only_no_apply": 1.3286, "no_prng": 1.3595,
                         "matmul_only": 1.2553, "batched4": 1.3414, "batched8": 2.2337}


def time_flash_ladder(dev) -> tuple[list, dict]:
    """The ladder's own path: ``tools/flash_microab.ladder`` at the train
    shape, every rung's launches read from that run alone; then each rung's
    plain version on the same inputs, and ``full`` beside K4a's
    ``flash_forward(seed=)``, the same kernel, in turns (rung, K4a, K4a,
    rung), all outside the counted run: the two must agree within the
    run's spread (the larger of the two pairs' differences, and 2% of
    their mean)."""
    from applecider_tpu_torch.ops import flash_attention as fa
    from applecider_tpu_torch.ops import flash_microab as fm
    from applecider_tpu_torch.tools import flash_microab as tool

    counters = zero_counters()
    report = tool.ladder(dev)
    launches = {name: k.launches for name, k in counters.items()}
    missing = [m for m in fm.MODES if launches[LADDER_PREFIX + m] == 0]
    stray = [n for n in launches if not n.startswith(LADDER_PREFIX) and launches[n]]
    if missing or stray:
        raise SystemExit(f"the ladder never launched {missing}, or launched other kernels {stray}")
    q, k, v, mask = tool.make_inputs(device=dev)
    shape = "B={B} H={H} L={L} hd={hd} rate=".format(**report["shape"]) + str(report["rate"])
    records = []
    for mode in fm.MODES:
        r = report["rungs"][mode]
        plain = time_ms(lambda: fm.flash_forward_ablation_reference(q, k, v, mask, mode, tool.RATE,
                                                                    tool.SEED), iters=2, reps=3)
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"K4x ladder {mode} {shape} bf16 ({r['route']}): kernel {r['ms']:.4f} ms "
            f"(FMA kernel earlier: {LADDER_FMA_EARLIER_MS[mode]:.4f}), plain {plain:.4f} ms, sdpa {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), launches {launches[LADDER_PREFIX + mode]}")
        line = 79 if mode.startswith("batched") else 41
        records.append(dict(name=LADDER_PREFIX + mode, route="cuda", kernel=r["route"],
                            source="applecider_tpu_torch/csrc/flash_attention.cu",
                            replaces=f"scripts/tpu_flash_microab.py:{line}", shape=shape,
                            dtype="bfloat16", ms=r["ms"], plain_ms=plain, bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    for name, st in report["stages"].items():
        log(f"K4x split of full: {name} {st['ms']:+.4f} ms ({st['share_of_full']:+.1%})")
    rung, k4a = [], []
    for timed in (rung, k4a, k4a, rung):
        if timed is rung:
            timed.append(time_ms(lambda: fm.flash_forward_ablation(q, k, v, mask, "full", tool.RATE, tool.SEED)))
        else:
            timed.append(time_ms(lambda: fa.flash_forward(q, k, v, mask, tool.RATE, seed=tool.SEED)))
    gap = abs(np.mean(rung) - np.mean(k4a))
    spread = max(abs(rung[0] - rung[1]), abs(k4a[0] - k4a[1]), 0.02 * np.mean(rung + k4a))
    log(f"K4a forward on the ladder's inputs ({shape} bf16), in turns: the ladder's full {rung[0]:.4f}, "
        f"{rung[1]:.4f} ms; flash_forward(seed) {k4a[0]:.4f}, {k4a[1]:.4f} ms; gap {gap:.4f} ms "
        f"(<= spread {spread:.4f} ms required)")
    if gap > spread:
        raise SystemExit("the ladder's full and K4a's forward, one kernel, timed apart beyond the run's spread")
    return records, launches


def _ln_gelu_bwd_inputs(rng, N, C, dev, dtype=None):
    import torch

    x = torch.from_numpy((rng.normal(size=(N, C)) * 2.0 + 0.5).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.normal(size=(N, C)).astype(np.float32)).to(dev, dtype)
    scale = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(0.0, 0.1, C).astype(np.float32)).to(dev)
    return x, scale, bias, g


# (N, C) of K3b's ragged cases: fewer rows than a block's row groups, rows
# not a multiple of the grid's, odd and uneven widths (one element a
# vector), rows wider than SpectraNet's (8 vectors a thread), the widest a
# group holds, and wider rows, which stream (odd above 4096, even above
# 8192, fewer rows than the grid's blocks)
LN_GELU_BWD_RAGGED = ((5, 192), (1, 3072), (1000, 1), (777, 33), (4099, 200), (100, 5000),
                      (50, 8192), (64, 4095), (97 * 3481 + 3, 192), (301, 4097), (97, 8191),
                      (300, 10000), (3, 20001))


def _compare_ln_gelu_bwd(x, scale, bias, g, what, geo) -> float:
    """K3b on (x, scale, bias, g) against ``ln_gelu_backward_reference`` on
    the same inputs, and a second launch, which must give the same bits.
    f32: dx <= 1e-5 * max(1, |dx|); bf16: dx <= 2e-2 * max(1, |plain|)
    (both round the same f32 dx once); dscale and dbias <= 1e-4 * max|.|
    in both (f32 sums over up to 9e5 rows in another order). Raises on a
    failure; returns dx's max |d|."""
    import torch

    from applecider_tpu_torch.ops import ln_gelu as lg

    N, C = x.shape
    dx, ds, db = lg.ln_gelu_backward(x, scale, bias, g)
    wdx, wds, wdb = lg.ln_gelu_backward_reference(x, scale, bias, g)
    e_dx, ok_dx = _rel_ok(dx, wdx, 1e-5 if x.dtype == torch.float32 else 2e-2)
    e_ds = max(float((ds - wds).abs().max()) / max(float(wds.abs().max()), 1e-30),
               float((db - wdb).abs().max()) / max(float(wdb.abs().max()), 1e-30))
    del wdx
    again = lg.ln_gelu_backward(x, scale, bias, g)
    same = all(torch.equal(a, b) for a, b in zip((dx, ds, db), again))
    ok = ok_dx and e_ds <= 1e-4 and same
    dname = "float32" if x.dtype == torch.float32 else "bfloat16"
    rule = "<= 1e-5*max(1,|dx|)" if x.dtype == torch.float32 else "<= 2e-2*max(1,|plain|)"
    log(f"K3b ln_gelu_bwd N={N} C={C} {dname} ({what}, {geo}): dx max|d|={e_dx:.3g} "
        f"({rule}), dscale/dbias max|d|/max|.|={e_ds:.3g} (<= 1e-4), second launch bitwise equal: "
        f"{same} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"K3b disagrees with its plain version, or with itself, at N={N} C={C} {dname}")
    return e_dx


def _check_ln_gelu_bwd_case(rng, dev, N, C, dtype, what, misalign=False) -> float:
    """``_compare_ln_gelu_bwd`` on fresh inputs of (N, C). ``misalign``
    starts x and g one element past an aligned address, which takes
    one-element accesses."""
    import torch

    from applecider_tpu_torch.ops import ln_gelu as lg

    x, scale, bias, g = _ln_gelu_bwd_inputs(rng, N, C, dev, dtype)
    if misalign:  # the same values one element into a fresh buffer
        x, g = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(N, C) for t in (x, g))
    return _compare_ln_gelu_bwd(x, scale, bias, g, what, lg.bwd_geometry(N, C, 1 if misalign else 2))


def time_ln_gelu_bwd_stages(dev) -> list[dict]:
    """K3b at every train-shape stage (TRAIN_B spectra, f32, the input the
    training step gives it): first held against its plain version on the
    same inputs (``_compare_ln_gelu_bwd``: f32 limits, two launches
    bitwise equal; ``max_abs_err``), then the wrapper's time as every
    kernel is timed here (``ms``), its device time alone (``device_ms``:
    the calls queued first), the plain version's and the byte bound, x and
    g read once and dx written once."""
    from applecider_tpu_torch.ops import ln_gelu as lg

    rng = np.random.default_rng(3)
    rows = []
    for C, L in LN_GELU_SHAPES:
        N = TRAIN_B * L
        x, scale, bias, g = _ln_gelu_bwd_inputs(rng, N, C, dev)
        err = _compare_ln_gelu_bwd(x, scale, bias, g, f"train shape, L_stage={L}", lg.bwd_geometry(N, C))
        ms_k = time_ms(lambda: lg.ln_gelu_backward(x, scale, bias, g))
        ms_d = time_ms(lambda: lg.ln_gelu_backward(x, scale, bias, g), queued=True)
        ms_p = time_ms(lambda: lg.ln_gelu_backward_reference(x, scale, bias, g), iters=2, reps=3)
        b_ms, b_by = bound_ms(3 * N * C * 4 + 4 * C * 4, 40.0 * N * C, "float32")
        rows.append(dict(C=C, N=N, max_abs_err=err, ms=ms_k, device_ms=ms_d, plain_ms=ms_p, bound_ms=b_ms,
                         bound_by=b_by))
        del x, g
    return rows


def check_ln_gelu_bwd(rng, dev, rows: int = 64) -> dict:
    """K3b against ``ln_gelu_backward_reference`` (``_compare_ln_gelu_bwd``:
    tolerances, and two launches bitwise equal) at every SpectraNet stage
    with ``rows`` spectra in f32 and bf16, at ``LN_GELU_BWD_RAGGED`` in both
    dtypes, and with misaligned rows at stage 0 and at a width that streams;
    then at every train-shape stage, checked in f32 on the inputs it is
    timed on (the record's ``max_abs_err`` is stage 0's), and PyTorch's own
    backward through ``F.gelu(F.layer_norm(...))`` at stage 0 beside it, as
    context (two library kernels, not one call: library_ms stays null)."""
    import torch
    import torch.nn.functional as F

    for C, L in LN_GELU_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            _check_ln_gelu_bwd_case(rng, dev, rows * L, C, dtype, f"stage L_stage={L}")
    for N, C in LN_GELU_BWD_RAGGED:
        for dtype in (torch.float32, torch.bfloat16):
            _check_ln_gelu_bwd_case(rng, dev, N, C, dtype, "ragged")
    for N, C in ((rows * LN_GELU_SHAPES[0][1], LN_GELU_SHAPES[0][0]), (64, 6000)):
        for dtype in (torch.float32, torch.bfloat16):
            _check_ln_gelu_bwd_case(rng, dev, N, C, dtype, "rows one element off alignment", misalign=True)

    stages = time_ln_gelu_bwd_stages(dev)
    for st in stages:
        log(f"K3b ln_gelu_bwd N={st['N']} C={st['C']} float32 (train shape): kernel {st['ms']:.4f} ms "
            f"(device alone {st['device_ms']:.4f} ms) plain {st['plain_ms']:.4f} ms bound "
            f"{st['bound_ms']:.5f} ms ({st['bound_by']}), {st['bound_ms'] / st['ms']:.1%} of the bound; "
            f"library none")
    total, total_bound = sum(st["ms"] for st in stages), sum(st["bound_ms"] for st in stages)
    total_dev = sum(st["device_ms"] for st in stages)
    log(f"K3b over the five train-shape stages (one training step's launches): {total:.4f} ms "
        f"(device alone {total_dev:.4f} ms) against a bound of {total_bound:.4f} ms")
    C, L = LN_GELU_SHAPES[0]
    N = TRAIN_B * L
    x, scale, bias, g = _ln_gelu_bwd_inputs(rng, N, C, dev)
    xr, sr, br = (t.clone().requires_grad_() for t in (x, scale, bias))
    y = F.gelu(F.layer_norm(xr, (C,), sr, br))
    ms_lib = time_ms(lambda: torch.autograd.grad(y, (xr, sr, br), g, retain_graph=True))
    log(f"PyTorch's backward through F.gelu(F.layer_norm(...)) at N={N} C={C} float32, as context "
        f"(two library kernels): {ms_lib:.4f} ms, kernel/that {stages[0]['ms'] / ms_lib:.2f}")
    del x, g, xr, y
    st0 = stages[0]
    return dict(name="ln_gelu_bwd", route="cuda", source="applecider_tpu_torch/csrc/ln_gelu.cu",
                replaces="applecider_tpu/ops/ln_gelu.py:89", shape=f"N={st0['N']} C={st0['C']}",
                dtype="float32", max_abs_err=st0["max_abs_err"], ms=st0["ms"], plain_ms=st0["plain_ms"],
                bound_ms=st0["bound_ms"], bound_by=st0["bound_by"], library_ms=None,
                stages=stages, stages_ms=total, stages_device_ms=total_dev, stages_bound_ms=total_bound)


def check_kernels() -> tuple[list[dict], dict]:
    """Phase 2: the kernel records, and the ladder's launch counts."""
    import torch

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    records = [check_merge_scan(rng, dev), check_attention(rng, dev), check_ln_gelu(rng, dev)]
    check_flash_bits(rng, dev)
    check_flash_prng(rng, dev)
    fwd, bwd = time_flash(rng, dev)
    records += [check_ln_gelu_bwd(rng, dev), fwd, bwd]
    ladder_errs = check_flash_ladder(rng, dev)
    check_draw_in_sass()
    check_tensor_cores()
    ladder, ladder_launches = time_flash_ladder(dev)
    for r in ladder:
        r["max_abs_err"] = ladder_errs[r["name"].removeprefix(LADDER_PREFIX)]
    torch.cuda.empty_cache()
    return records + ladder, ladder_launches


# ------------------------------------------------------------- phase 3
def kernel_counters() -> dict:
    from applecider_tpu_torch.ops import attention, flash_attention, flash_microab, ln_gelu, merge_scan

    return {"merge_scan": merge_scan.KERNEL, "masked_attention": attention.KERNEL,
            "ln_gelu_fwd": ln_gelu.KERNEL, "ln_gelu_bwd": ln_gelu.KERNEL_BWD,
            "flash_attention_fwd": flash_attention.KERNEL_FWD,
            "flash_attention_bwd": flash_attention.KERNEL_BWD,
            **{LADDER_PREFIX + m: k for m, k in flash_microab.KERNELS.items()}}


SERVING_KERNELS = ("merge_scan", "masked_attention", "ln_gelu_fwd")
# launches per train step: 4 attention layers, 5 SpectraNet blocks
TRAINING_KERNELS = {"flash_attention_fwd": 4, "flash_attention_bwd": 4, "ln_gelu_fwd": 5,
                    "ln_gelu_bwd": 5}
LADDER_PREFIX = "flash_microab_"  # K4x's rungs, launched by the ladder's own path


def zero_counters() -> dict:
    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    return counters


def _kernel_launches(counters: dict) -> dict:
    return {name: k.launches for name, k in counters.items()}


def _require_serving_launches(launches: dict, walked, what: str) -> None:
    """Every serving kernel launched, no training kernel, no K1 row walked
    with the recurrence."""
    missing = [n for n in SERVING_KERNELS if launches[n] == 0]
    if missing:
        raise SystemExit(f"{what} never launched: {missing}")
    stray = [n for n in launches if n not in SERVING_KERNELS and launches[n]]
    if stray:
        raise SystemExit(f"{what} launched training kernels: {stray}")
    if walked.item():
        raise SystemExit(f"K1 walked {int(walked.item())} rows of {what} instead of taking its "
                         "parallel path")


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
    from applecider_tpu_torch.ops import merge_scan
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
    counters = zero_counters()
    walked = merge_scan.walked_rows(device) if str(device).startswith("cuda") else torch.zeros(1)
    walked.zero_()
    probs, n_batches, secs = serve(feeder(), samples, model.num_classes)
    launches = _kernel_launches(counters)

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
        log(f"K1 rows walked with the recurrence in that run: {int(walked.item())} (0 required)")
        _require_serving_launches(launches, walked, "the serving path")

    # f32, TF32 off: kernel path vs plain path, same weights and alerts
    model32 = build_fusion_model(cfg, device=device, dtype=torch.float32)
    model32.load_state_dict(model.state_dict())
    sub = samples[:n_parity]
    with no_tf32():
        got = FusedSpectraStream(model32, device=device)(sub, length_buckets=LENGTH_BUCKETS)
        want = FusedSpectraStream(model32, device=device, kernels=False)(
            sub, length_buckets=LENGTH_BUCKETS)
    err = float(np.abs(got - want).max())
    log(f"f32 (TF32 off) kernel path vs plain path, {n_parity} alerts: max|dprob| = {err:.3g} "
        f"(<= 1e-4 required)")
    if not err <= 1e-4:
        raise SystemExit("f32 serving path disagrees with the plain path")
    return {"launches": launches, "batches": n_batches, "alerts_per_s": n_alerts / secs,
            "parity_err": err, "model": model, "model32": model32}


# ------------------------------------------------------------- phase 3b
def _stamp_records(pairs: list, data_dir: Path) -> list:
    """Records carrying raw stamps: each sample without its image, with the
    three gzipped FITS blobs its alert carries in ``alerts.npy``."""
    from applecider_tpu_torch.infer.serve import CUTOUT_KEYS

    blobs = {}
    for obj in sorted({i["object_id"] for i, _ in pairs}):
        for a in np.load(data_dir / obj / "alerts.npy", allow_pickle=True):
            blobs[(obj, float(a["candidate"]["jd"]))] = [a[k]["stampData"] for k in CUTOUT_KEYS]
    return [{**{k: v for k, v in s.items() if k != "image"},
             "stamps": blobs[(i["object_id"], i["jd"])]} for i, s in pairs]


def host_split(data_dir: Path) -> dict:
    """Milliseconds of each host step of reading the corpus, one pass each
    over every object: unpickling ``alerts.npy``, decoding the stamps as
    the reader does (one native call an object, every core), reading
    ``photometry.csv`` with the alerts' photometry, reading
    ``spectra.csv``; and, beside them, the same stamps decoded by the
    native decoder on one thread and by ``decode_stamp`` in Python (one
    thread)."""
    from applecider_tpu_torch.infer.serve import (
        CUTOUT_KEYS, _alert_triplet, _decode_all_triplets, _raw_spectrum,
    )
    from applecider_tpu_torch.native import decode_stamps_batch
    from applecider_tpu_torch.preprocessing.photometry import load_photometry
    from applecider_tpu_torch.preprocessing.spectra import (
        extract_spectrum_time_mjd, read_spectra_csv,
    )

    keys = ("alerts_npy", "stamps", "photometry_csv", "spectra_csv", "stamps_native_one_thread",
            "stamps_python")
    ms = dict.fromkeys(keys, 0.0)
    for obj in sorted(p.name for p in data_dir.iterdir()):
        t0 = time.perf_counter()
        alerts = list(np.load(data_dir / obj / "alerts.npy", allow_pickle=True))
        t1 = time.perf_counter()
        _decode_all_triplets(alerts)
        t2 = time.perf_counter()
        load_photometry(obj, data_dir, alerts=alerts)
        t3 = time.perf_counter()
        df = read_spectra_csv(obj, data_dir)
        _raw_spectrum(df), extract_spectrum_time_mjd(df)
        t4 = time.perf_counter()
        decode_stamps_batch([a[k]["stampData"] for a in alerts for k in CUTOUT_KEYS], n_threads=1)
        t5 = time.perf_counter()
        [_alert_triplet(a) for a in alerts]
        t6 = time.perf_counter()
        for k, a, b in zip(keys, (t0, t1, t2, t3, t4, t5), (t1, t2, t3, t4, t5, t6)):
            ms[k] += (b - a) * 1e3
    return ms


def check_raw_serving(model, model32, card: str, tmp: Path, n_objects: int = 128,
                      alerts_per_object: int = 16, batch_size: int = 512, n_parity: int = 256,
                      seed: int = 5) -> dict:
    """Phase 3b: raw-alert serving, from object directories on disk to
    per-alert probabilities, with phase 3's weights.

    A corpus of ``n_objects`` directories (``testing.make_corpus``: light
    curves of U(20, 300) points, ``alerts_per_object`` alerts each, 30% of
    the objects with a spectrum, 63x63 gzipped FITS stamps) is read once
    for the host's time alone, then served through
    ``serve_alert_stream(model, iter_alert_samples(dir))`` (binned, bf16)
    with the kernels' launch counts read from that run alone, and served
    again from the samples already read. In f32 with TF32 off, on the first
    ``n_parity`` alerts: binned against arrival order, ``RoutedAlertStream``
    against ``FusedSpectraStream`` and the kernel path against the plain
    path, each within 1e-4 in probability; ``OverlappedServingFeeder`` in
    thread and process mode on records carrying stamps against the serial
    router within 1e-6. The corpus is written under ``tmp``, which the
    caller owns (phase 9 serves it again).
    """
    import torch

    from applecider_tpu_torch.infer.feeder import OverlappedServingFeeder, assemble_samples
    from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
    from applecider_tpu_torch.infer.stream import (
        LENGTH_BUCKETS, FusedSpectraStream, RoutedAlertStream,
    )
    from applecider_tpu_torch.ops import merge_scan
    from applecider_tpu_torch.testing import make_corpus

    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    data_dir, _ = make_corpus(tmp, n_objects=n_objects, seed=seed, n_photometry=(20, 300),
                              n_alerts=alerts_per_object, spectrum_frac=0.3)
    size = sum(f.stat().st_size for f in data_dir.rglob("*") if f.is_file())
    n_spec_objects = len(list(data_dir.glob("*/spectra.csv")))
    log(f"raw corpus: {n_objects} object directories, {alerts_per_object} alerts each, "
        f"{n_spec_objects} with a spectrum, {size / 2**20:.1f} MiB, written in "
        f"{time.perf_counter() - t0:.1f} s [{card}]")

    # the host alone: read CSVs and alerts, decode stamps, cut per alert
    t0 = time.perf_counter()
    pairs = list(iter_alert_samples(data_dir))
    host_s = time.perf_counter() - t0
    n = len(pairs)
    lengths = np.asarray([i["n_photometry"] for i, _ in pairs])
    fill = {b: int(((lengths <= b) & (lengths > lo)).sum())
            for lo, b in zip((0,) + LENGTH_BUCKETS[:-1], LENGTH_BUCKETS)}
    fill[LENGTH_BUCKETS[-1]] += int((lengths > LENGTH_BUCKETS[-1]).sum())  # truncated to 257
    n_with_spec = sum(i["has_spectrum"] for i, _ in pairs)
    log(f"raw-alert host ms: {host_s * 1e3:.1f} ms to read and decode {n} alerts from "
        f"{n_objects} directories ({n / host_s:.1f} alerts/s; one host thread, but the stamps "
        f"decoded on every core) [{card}]")
    log(f"  alerts by length bucket {fill}; {n_with_spec} with a spectrum")
    split = host_split(data_dir)
    read_ms = sum(split[k] for k in ("alerts_npy", "stamps", "photometry_csv", "spectra_csv"))
    log(f"  host split, ms over the corpus: {', '.join(f'{k} {v:.1f}' for k, v in split.items())} "
        f"[{card}]")
    log(f"  host reading {read_ms:.1f} ms, the stamps (native decoder, every core) "
        f"{split['stamps'] / read_ms * 100:.1f}% of it; the same stamps on one host thread: "
        f"native {split['stamps_native_one_thread']:.1f} ms, Python decode_stamp "
        f"{split['stamps_python']:.1f} ms [{card}]")
    if n < 0.9 * n_objects * alerts_per_object or min(fill.values()) == 0:
        raise SystemExit(f"the raw corpus gave {n} alerts, length buckets {fill}")

    # the counted run, from the directories (bf16, binned)
    counters = zero_counters()
    walked = merge_scan.walked_rows(dev) if on_card else torch.zeros(1)
    walked.zero_()
    sync()
    summary = serve_alert_stream(model, iter_alert_samples(data_dir), batch_size=batch_size,
                                 device=dev)
    launches = _kernel_launches(counters)
    probs = np.stack([r["probs"] for r in summary["results"]])
    sums = probs.sum(axis=1)
    if probs.shape != (n, model.num_classes) or not np.isfinite(probs).all() \
            or float(np.abs(sums - 1).max()) > 1e-3:
        raise SystemExit(f"raw serving output not finite rows of ({n}, {model.num_classes}) "
                         "summing to 1 within 1e-3")
    if [(r["object_id"], r["jd"]) for r in summary["results"]] != \
            [(i["object_id"], i["jd"]) for i, _ in pairs]:
        raise SystemExit("raw serving results are not in arrival order")
    log(f"raw-alert serving bf16 from the directories: {n} alerts in {summary['seconds']:.4f} s, "
        f"{summary['alerts_per_sec']:.1f} alerts/s, host reading and decoding included "
        f"(batch_size={batch_size}, binned) [{card}]; max |sum-1| {float(np.abs(sums - 1).max()):.3g}")
    log(f"launches in that run: K1 {launches['merge_scan']}, K2 {launches['masked_attention']}, "
        f"K3f {launches['ln_gelu_fwd']} [{card}] (all: {launches})")
    log(f"K1 rows walked with the recurrence in that run: {int(walked.item())} (0 required)")
    if on_card:
        _require_serving_launches(launches, walked, "the raw-alert serving path")

    # the same alerts from the samples already read: the device side alone
    sync()
    again = serve_alert_stream(model, iter(pairs), batch_size=batch_size, device=dev)
    log(f"  the same {n} alerts from samples already in memory: {again['seconds']:.4f} s, "
        f"{again['alerts_per_sec']:.1f} alerts/s; host read+decode is "
        f"{host_s / (host_s + again['seconds']) * 100:.1f}% of read+serve [{card}]")
    got = np.stack([r["probs"] for r in again["results"]])
    if not np.allclose(got, probs, rtol=0, atol=2e-2):
        raise SystemExit("serving from directories and from samples disagree beyond bf16")
    rate = summary["alerts_per_sec"]
    del summary, again

    # f32, TF32 off, first n_parity alerts
    sub = pairs[:n_parity]
    samples = [s for _, s in sub]
    checks = {}
    with no_tf32():
        def served(**kw):
            out = serve_alert_stream(model32, iter(sub), batch_size=batch_size, device=dev, **kw)
            return np.stack([r["probs"] for r in out["results"]])

        binned, arrival = served(binned=True), served(binned=False)
        plain = served(binned=False, kernels=False)
        fused = FusedSpectraStream(model32, device=dev)(samples, length_buckets=LENGTH_BUCKETS)
        routed = RoutedAlertStream(model32, device=dev)(samples, length_buckets=LENGTH_BUCKETS)
        checks["binned vs arrival order"] = float(np.abs(binned - arrival).max())
        checks["RoutedAlertStream vs FusedSpectraStream"] = float(np.abs(routed - fused).max())
        checks["kernel path vs kernels=False"] = float(np.abs(arrival - plain).max())
        for what, err in checks.items():
            log(f"raw-alert f32 (TF32 off), {len(sub)} alerts: {what} max|dprob| = {err:.3g} "
                f"(<= 1e-4 required) [{card}]")
        bad = [w for w, e in checks.items() if not e <= 1e-4]
        if bad:
            raise SystemExit(f"raw-alert f32 serving disagrees: {bad}")

        # the overlapped feeder on records carrying stamps, against the serial router
        records = _stamp_records(sub, data_dir)
        batches = [records[i:i + 64] for i in range(0, len(records), 64)]
        router = FusedSpectraStream(model32, device=dev)
        want = [router(assemble_samples(rb), length_buckets=LENGTH_BUCKETS) for rb in batches]
        for mode in ("thread", "process"):
            t0 = time.perf_counter()
            feeder = OverlappedServingFeeder(router, n_workers=2, depth=2, mode=mode,
                                             length_buckets=LENGTH_BUCKETS)
            got = list(feeder.serve(iter(batches)))
            secs = time.perf_counter() - t0
            err = max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
                if len(got) == len(want) else float("inf")
            checks[f"OverlappedServingFeeder {mode} vs serial"] = err
            log(f"OverlappedServingFeeder mode={mode}: {len(got)} batches of 64 records with stamps "
                f"in {secs:.2f} s (worker start included); max|dprob| vs the serial router "
                f"{err:.3g} (<= 1e-6 required) [{card}]")
            if not err <= 1e-6:
                raise SystemExit(f"OverlappedServingFeeder ({mode}) disagrees with the serial router")
    if on_card:
        torch.cuda.empty_cache()
    return {"launches": launches, "alerts": n, "alerts_per_s": rate, "host_ms": host_s * 1e3,
            "host_split_ms": split, "checks": checks, "data_dir": data_dir, "pairs": pairs}



# ------------------------------------------------------------- phase 4
def _timed_steps(trainer) -> list:
    """Wrap ``trainer.train_step`` so that each step ends in a synchronise
    and its wall time is recorded; returns the list the times go to."""
    import torch

    times = []
    step = trainer.train_step

    def timed(batch, kernels=True):
        t0 = time.perf_counter()
        out = step(batch, kernels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    trainer.train_step = timed
    return times


def check_training(card: str, workdir: Path, batch_size: int = 256, steps: int = 12) -> dict:
    """Phase 4: ``Trainer.fit`` at the full widths in bf16 for one epoch."""
    import torch

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.datasets.loader import DataLoader
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.fusion import AppleCiderTask, to_tensor
    from applecider_tpu_torch.testing import SyntheticFusionDataset
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = load_defaults()
    model = build_fusion_model(cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    task = AppleCiderTask(cfg, model)
    before = [p.detach().clone() for p in model.parameters()]
    data = SyntheticFusionDataset(batch_size * steps, seed=2)
    loader = DataLoader(data, batch_size=batch_size, seed=0, drop_last=True, prefetch=2)
    trainer = Trainer(task, cfg, workdir)
    times = _timed_steps(trainer)
    torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    t0 = time.perf_counter()
    out = trainer.fit(loader, epochs=1)
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    rec = out["history"][0]
    changed = sum(int(not torch.equal(a, p.detach())) for a, p in zip(before, model.parameters()))
    del before
    step_ms = float(np.median(times[1:])) * 1e3
    log(f"training bf16, full widths, batch {batch_size}: {len(times)} steps in {wall:.2f} s "
        f"(fit, with loading and two checkpoints); step times ms "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)}; median after the first {step_ms:.2f} ms, "
        f"{batch_size / step_ms * 1e3:.1f} samples/s; peak memory {peak / 2**30:.2f} GiB [{card}]")
    log(f"train_loss {rec['train_loss']:.5f} last_grad_norm {rec['last_grad_norm']:.4f}; "
        f"{changed} of {len(list(model.parameters()))} parameter tensors changed")
    log(f"launches in that run: {launches} ({len(times)} steps)")
    if len(times) != steps or not np.isfinite(rec["train_loss"]) or changed == 0:
        raise SystemExit("the training phase did not run its steps, or its loss is not finite, "
                         "or no parameter changed")
    wrong = {n: launches[n] for n, per in TRAINING_KERNELS.items() if launches[n] != per * steps}
    stray = [n for n in launches if n not in TRAINING_KERNELS and launches[n]]
    if wrong or stray:
        raise SystemExit(f"training launches off the expected {TRAINING_KERNELS} per step: "
                         f"{wrong}; serving kernels launched: {stray}")

    # resume: a new Trainer on the same workdir continues at epoch 1
    resumed = Trainer(task, cfg, workdir).fit(
        DataLoader(SyntheticFusionDataset(batch_size, seed=3), batch_size=batch_size, seed=0,
                   drop_last=True), epochs=2)
    epochs_run = [r["epoch"] for r in resumed["history"]]
    log(f"resumed from {workdir / 'checkpoints' / 'last.pt'}: epochs run {epochs_run}")
    if epochs_run != [1] or resumed["history"][0]["steps"] != steps + 1:
        raise SystemExit("fit did not resume from its checkpoint at epoch 1")

    # the attention's route: autograd in eval mode reaches K4 (rate 0), no
    # autograd reaches K2
    batch = trainer.to_device(to_tensor(loader.dataset.collate(
        [loader.dataset.sample(i) for i in range(8)])))
    counters = zero_counters()
    loss, _ = task.loss(batch, train=False)
    loss.backward()
    with torch.no_grad():
        task.loss(batch, train=False)
    routes = {name: k.launches for name, k in counters.items()}
    log(f"eval forward+backward with autograd, then eval forward without: launches {routes}")
    if routes["flash_attention_fwd"] != 4 or routes["flash_attention_bwd"] != 4 \
            or routes["masked_attention"] != 4:
        raise SystemExit("the attention did not route K4 under autograd and K2 without it")
    del trainer, model
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "samples_per_s": batch_size / step_ms * 1e3,
            "peak_gib": peak / 2**30, "step_times_ms": [t * 1e3 for t in times]}


# ------------------------------------------------------------- phase 5
def _record_ln_gelu(model) -> tuple[list, list]:
    """Hooks on every SpectraNet LN+GELU: its input x and parameters, the
    argmax of each max-pool window it feeds (the global max over length for
    the last block), the gradient g of its output and the dx its backward
    returned."""
    import torch.nn.functional as F

    enc = model.spectra_encoder
    records, handles = [], []
    for name in enc.block_names:
        blk = enc.get_submodule(name)
        rec = {}
        records.append(rec)

        def fwd(mod, inputs, y, rec=rec, blk=blk):
            y = y.detach()
            if blk.do_pool:
                z = F.linear(y, blk.downsample.weight[:, :, 0]) + blk.downsample.bias
                B, L, C = z.shape
                rec["arg"] = z[:, : L // 4 * 4].reshape(B, L // 4, 4, C).argmax(dim=2)
            else:
                rec["arg"] = y.argmax(dim=1)
            rec["x"] = inputs[0].detach()
            rec["w"], rec["b"] = mod.weight.detach().clone(), mod.bias.detach().clone()

        def bwd(mod, grad_in, grad_out, rec=rec):
            rec["dx"], rec["g"] = grad_in[0].detach(), grad_out[0].detach()

        handles += [blk.norm.register_forward_hook(fwd), blk.norm.register_full_backward_hook(bwd)]
    return records, handles


def check_training_parity(workdir: Path, batch_size: int = 32, lr: float = 1e-4) -> dict:
    """One f32 step, TF32 off, dropout live: kernel path vs plain path, the
    same weights and the same draws (FastDropout from equal device
    generators, K4 through the Philox twin).

    - |dloss| <= 1e-5.
    - Outside SpectraNet every gradient is within tol = 1e-4 * max(1,
      max|g|) of its parameter's (the kernels sum in another order than
      the plain versions, and cuDNN's weight gradients are not
      deterministic); after the Adam step, parameters are within 1e-6 where
      |g| >= max(1e-5, tol) and within 2 * lr + 1e-7 elsewhere: Adam's first
      step is lr * g / (|g| + 1e-8), so an entry whose two gradients differ
      in sign, which only an entry below the tolerance can, moves by up to
      2 * lr.
    - In SpectraNet, K3's backward inside the step, on the x and g it was
      given there, is within 1e-5 * max(1, |dx|) of the plain backward's dx.
    - SpectraNet's max pools send each gradient to the argmax of its window,
      and the two paths' activations differ by ~1e-6 after a few stages,
      which moves the argmax of nearly tied windows and with it whole
      gradient entries (the count is printed). Its parameters' gradients are
      therefore held in norm, ||dg|| <= 5e-2 * ||g|| per tensor, and the
      parameters within 2 * lr + 1e-7 after the step.
    """
    import torch

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.models.fusion import AppleCiderTask, to_tensor
    from applecider_tpu_torch.ops.ln_gelu import ln_gelu_backward_reference
    from applecider_tpu_torch.testing import SyntheticFusionDataset
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = load_defaults()
    cfg.set("train.compute_dtype", "float32")
    cfg.set("model.AppleCider.lr", lr)
    model_k = build_fusion_model(cfg, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    model_p = copy.deepcopy(model_k)
    data = SyntheticFusionDataset(batch_size, seed=4)
    host = to_tensor(data.collate([data.sample(i) for i in range(batch_size)]))
    out = {}
    for name, model, kernels in (("kernel", model_k, True), ("plain", model_p, False)):
        trainer = Trainer(AppleCiderTask(cfg, model), cfg, workdir / name, seed=11)
        records, handles = _record_ln_gelu(model)
        with no_tf32():
            m = trainer.train_step(trainer.to_device(host), kernels=kernels)
        for h in handles:
            h.remove()
        out[name] = (float(m["loss"]), float(m["grad_norm"]),
                     {n: p.grad.detach() for n, p in model.named_parameters()}, records)
    (lk, nk, gk, rec_k), (lp, np_, gp, rec_p) = out["kernel"], out["plain"]
    flips = [int((a["arg"] != b["arg"]).sum()) for a, b in zip(rec_k, rec_p)]
    ok = abs(lk - lp) <= 1e-5
    k3b_err, k3b_ok = 0.0, True
    for rec in rec_k:
        want, _, _ = ln_gelu_backward_reference(rec["x"], rec["w"], rec["b"], rec["g"])
        e, o = _rel_ok(rec["dx"], want, 1e-5)
        k3b_err, k3b_ok = max(k3b_err, e), k3b_ok and o
    ok = ok and k3b_ok
    g_err, p_err, s_err, worst, s_worst = 0.0, 0.0, 0.0, "", ""
    bound = 2 * lr + 1e-7
    for (n, pk), pp in zip(model_k.named_parameters(), model_p.parameters()):
        dg = gk[n] - gp[n]
        dp = (pk.detach() - pp.detach()).abs()
        ok = ok and bool((dp <= bound).all())
        if n.startswith("spectra_encoder."):
            rel = float(dg.norm()) / max(float(gp[n].norm()), 1e-12)
            if rel > s_err:
                s_err, s_worst = rel, n
            ok = ok and rel <= 5e-2
            continue
        d = dg.abs().max().item()
        lim = 1e-4 * max(1.0, gp[n].abs().max().item())
        if d / lim > g_err:
            g_err, worst = d / lim, n
        big = gp[n].abs() >= max(1e-5, lim)
        p_err = max(p_err, float(dp[big].max()) if big.any() else 0.0)
        ok = ok and d <= lim and bool((dp[big] <= 1e-6).all())
    log(f"training parity f32 (TF32 off), batch {batch_size}, dropout live: loss {lk:.7f} vs "
        f"{lp:.7f} (|d| {abs(lk - lp):.3g} <= 1e-5); grad norm {nk:.6f} vs {np_:.6f}")
    log(f"  outside SpectraNet: worst gradient at {g_err:.3g} of its bound ({worst}); post-step "
        f"params max|d| where |g| >= max(1e-5, tol) {p_err:.3g} (<= 1e-6)")
    log(f"  K3b in the step vs the plain backward on the same x and g: dx max|d| {k3b_err:.3g} "
        f"(<= 1e-5*max(1,|dx|))")
    log(f"  SpectraNet: max-pool windows whose argmax differs between the two paths, per block "
        f"(the last the global max over length, of {rec_k[-1]['arg'].numel()}): {flips}; worst "
        f"||dg||/||g|| {s_err:.3g} (<= 5e-2, {s_worst}); every param within 2*lr + 1e-7 "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("the f32 training step disagrees between the kernel and plain paths")
    return {"loss_err": abs(lk - lp), "grad_err_of_bound": g_err, "param_err": p_err,
            "k3b_in_step_err": k3b_err, "spectra_rel_grad_err": s_err, "pool_flips": flips}


# ------------------------------------------------------------- phase 6
def _toml(tree: dict, prefix: str = "") -> str:
    """A nested dict of TOML values as TOML tables (keys with dots quoted)."""
    def key(k):
        return f'"{k}"' if "." in k else k

    scalars = {k: v for k, v in tree.items() if not isinstance(v, dict)}
    lines = [f"[{prefix}]"] if prefix and scalars else []
    lines += [f"{key(k)} = {json.dumps(v)}" for k, v in scalars.items()]
    for k, v in tree.items():
        if isinstance(v, dict):
            lines.append(_toml(v, f"{prefix}.{key(k)}" if prefix else key(k)))
    return "\n".join(lines) + "\n"


def _same_outputs(a: Path, b: Path) -> list:
    """The files two preprocessing runs wrote that differ: the CSVs as text
    with each run's root taken out of the paths, the npz files key by key,
    bit for bit."""
    differ = []
    for f in sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file()):
        x, y = a / f, b / f
        if not y.exists():
            differ.append(str(f))
        elif f.suffix == ".csv":
            if x.read_text().replace(str(a), "") != y.read_text().replace(str(b), ""):
                differ.append(str(f))
        else:
            with np.load(x, allow_pickle=True) as u, np.load(y, allow_pickle=True) as v:
                same = u.files == v.files and all(
                    u[k].dtype == v[k].dtype and u[k].shape == v[k].shape and (
                        list(u[k].ravel()) == list(v[k].ravel()) if u[k].dtype == object
                        else np.atleast_1d(u[k]).tobytes() == np.atleast_1d(v[k]).tobytes())
                    for k in u.files)
            if not same:
                differ.append(str(f))
    return differ


# launches per step: K4 forward and backward in each of the 4 attention
# layers, K3 forward and backward in each of the 5 SpectraNet blocks; per
# evaluation or inference batch (no autograd): K2 in each attention layer,
# K3f in each SpectraNet block
EVAL_KERNELS = {"masked_attention": 4, "ln_gelu_fwd": 5}


def check_workflow(card: str, tmp: Path, n_objects: int = 96, epochs: int = 3,
                   batch_size: int = 32, device="cuda", model_overrides: dict | None = None) -> dict:
    """Phase 6: the user's workflow through its own entry points, at the
    published widths. A raw corpus -> ``preprocess_data`` (serially and in
    a pool of 4, the same files) -> ``AppleCiderRuntime("configs/fusion.toml")``
    ``prepare``/``train`` in bf16 -> ``checkpoints/{best,last}.pt`` ->
    ``infer`` (kernel path against plain path in f32, TF32 off) -> ``serve``
    of every alert of the raw directories (against ``serve_alert_stream``
    run directly on a model loaded from ``best.pt``) -> the
    ``applecider-serve-torch`` CLI as a subprocess -> ``warmup`` twice.
    ``device`` and ``model_overrides`` (e.g. small widths) are for a dry run
    on the CPU. Everything is written under ``tmp``, which the caller owns;
    the result's ``runtime`` is the trained runtime (phase 9 exports it)."""
    import subprocess

    import torch

    from applecider_tpu_torch.datasets.photo_dataset import load_photo_stats
    from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.ops import merge_scan
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.preprocessing.table import read_csv
    from applecider_tpu_torch.testing import make_corpus
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    result: dict = {}
    t0 = time.perf_counter()
    raw, labels = make_corpus(tmp, n_objects=n_objects, seed=11, learnable=True,
                              n_photometry=(20, 100), spectrum_frac=0.3, n_alerts=8)
    log(f"workflow corpus: {n_objects} object directories (learnable, 20-100 points, 8 alerts, "
        f"30% with a spectrum) written in {time.perf_counter() - t0:.1f} s")

    # 1. preprocessing, serial and in a spawn pool of 4
    secs = {}
    for workers in (0, 4):
        t0 = time.perf_counter()
        preprocess_data(str(raw), str(labels), str(tmp / f"out{workers}"), num_workers=workers)
        secs[workers] = time.perf_counter() - t0
    out = tmp / "out0"
    built = read_csv(out / "built_all.csv")
    differ = _same_outputs(out, tmp / "out4")
    n_split = {s: len(read_csv(out / f"manifest_{s}.csv")) for s in ("train", "val", "test")}
    log(f"preprocess_data: {len(built)} of {n_objects} objects built, splits {n_split}; "
        f"serial {secs[0]:.2f} s ({n_objects / secs[0]:.1f} objects/s), 4 workers "
        f"{secs[4]:.2f} s ({n_objects / secs[4]:.1f} objects/s), host [{card}]; "
        f"files differing between the two: {differ}")
    if len(built) != n_objects or differ:
        raise SystemExit(f"preprocessing built {len(built)} of {n_objects} objects, or the "
                         f"serial and pooled runs differ: {differ}")
    result["preprocess_s"] = secs

    # 2. training through the runtime, bf16, dropout live
    section = 'applecider_tpu.datasets.fusion_dataset.FusionDataset'
    overrides = {"train": {"epochs": epochs}, "data_loader": {"batch_size": batch_size},
                 "data_set": {section: {"manifest_path": str(out / "manifest_train.csv"),
                                        "stats_event_path": str(out / "photo_stats.npz")}},
                 **(model_overrides or {})}
    workdir = tmp / "results"
    rt = AppleCiderRuntime(REPO / "configs" / "fusion.toml", overrides, workdir=workdir,
                           device=device)
    dev = rt.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    rt.prepare()
    n_train = len(rt.datasets["train"])
    val_batches = n_train // batch_size * epochs  # validate binds the same manifest
    counters = zero_counters()
    t0 = time.perf_counter()
    trained = rt.train()
    sync()
    wall = time.perf_counter() - t0
    launches = _kernel_launches(counters)
    run_dir = trained["run_dir"]
    history = trained["history"]
    steps = history[-1]["steps"]
    records = [json.loads(x) for x in (run_dir / "metrics.jsonl").read_text().splitlines()]
    ckpts = {t: (run_dir / "checkpoints" / f"{t}.pt").exists() for t in ("best", "last")}
    init = rt._task().module.state_dict()
    last = torch.load(run_dir / "checkpoints" / "last.pt", map_location=dev,
                      weights_only=True)["params"]
    moved = sum(int(not torch.equal(init[k], last[k])) for k in init)
    log(f"runtime train bf16, full widths: {n_train} training objects, {steps} steps of "
        f"{batch_size} over {epochs} epochs in {wall:.2f} s (validation and checkpoints "
        f"included); epoch seconds {[round(r['epoch_seconds'], 3) for r in records]}; "
        f"train_loss {[round(r['train_loss'], 4) for r in records]}; val_accuracy "
        f"{[round(r['val_accuracy'], 4) for r in records]} [{card}]")
    log(f"  {moved} of {len(init)} parameter tensors moved; checkpoints {ckpts}; "
        f"launches in that run: {launches}")
    want = {n: per * steps for n, per in TRAINING_KERNELS.items()}
    want["ln_gelu_fwd"] += EVAL_KERNELS["ln_gelu_fwd"] * val_batches
    want["masked_attention"] = EVAL_KERNELS["masked_attention"] * val_batches
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    stray = [n for n in launches if n not in want and launches[n]]
    if not all(np.isfinite(r["train_loss"]) for r in history) or moved == 0 \
            or not all(ckpts.values()) or steps != n_train // batch_size * epochs:
        raise SystemExit("runtime training: loss not finite, no parameter moved, a "
                         "checkpoint missing or a step short")
    if on_card and (wrong or stray):
        raise SystemExit(f"runtime training launches (got, expected): {wrong}; stray {stray}")
    result["train_launches"] = launches

    # 3. inference from the checkpoint, then f32 kernel path vs plain path
    counters = zero_counters()
    preds = rt.infer()
    infer_launches = _kernel_launches(counters)
    log(f"runtime infer bf16: predictions {preds.shape}, finite {bool(np.isfinite(preds).all())}; "
        f"launches {infer_launches}")
    if preds.ndim != 2 or preds.shape[1] != 5 or not len(preds) or not np.isfinite(preds).all():
        raise SystemExit("runtime infer did not return finite (n, 5) predictions")
    rt.set_config("train.compute_dtype", "float32")
    with no_tf32():
        got, plain = rt.infer(), rt.infer(kernels=False)
    rt.set_config("train.compute_dtype", "bfloat16")
    err = float(np.abs(got - plain).max())
    log(f"runtime infer f32 (TF32 off) kernel path vs plain path on best.pt: max|dlogit| "
        f"{err:.3g} (<= 1e-4 required)")
    if not err <= 1e-4:
        raise SystemExit("runtime infer: kernel path disagrees with the plain path")
    result["infer_err"] = err

    # 4. serving every alert of the raw directories with the trained weights
    n_alerts = sum(1 for _ in iter_alert_samples(raw))
    counters = zero_counters()
    walked = merge_scan.walked_rows(dev) if on_card else torch.zeros(1)
    walked.zero_()
    served = rt.serve(raw_path=raw)
    serve_launches = _kernel_launches(counters)
    log(f"runtime serve bf16: {served['n_alerts']} of {n_alerts} alerts in "
        f"{served['seconds']:.4f} s, {served['alerts_per_sec']:.1f} alerts/s, host reading "
        f"included [{card}]; launches {serve_launches}; K1 rows walked "
        f"{int(walked.item())} (0 required)")
    if served["n_alerts"] != n_alerts:
        raise SystemExit("runtime serve did not cover every alert")
    if on_card:
        _require_serving_launches(serve_launches, walked, "runtime serve")
    model = build_fusion_model(rt.config, device=dev)
    model.load_state_dict(torch.load(run_dir / "checkpoints" / "best.pt", map_location=dev,
                                     weights_only=True)["params"])
    mean, std = load_photo_stats(out / "photo_stats.npz")
    sec = rt.config.section("serve")
    direct = serve_alert_stream(model, iter_alert_samples(raw), batch_size=sec["batch_size"],
                                length_buckets=tuple(sec["length_buckets"]), stats_mean=mean,
                                stats_std=std, horizon_days=100.0, device=dev)
    err = float(np.abs(np.stack([r["probs"] for r in served["results"]])
                       - np.stack([r["probs"] for r in direct["results"]])).max())
    log(f"  runtime serve vs serve_alert_stream on best.pt directly: max|dprob| {err:.3g} "
        f"(<= 1e-6 required)")
    if not err <= 1e-6:
        raise SystemExit("runtime serve disagrees with serve_alert_stream on the same weights")
    result.update(serve_launches=serve_launches, alerts_per_s=served["alerts_per_sec"])
    del model

    # 5. the serving CLI in a process of its own, on the run's config
    run_toml = tmp / "run.toml"
    run_toml.write_text(_toml(rt.config))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "applecider_tpu_torch.infer.cli", "--config",
                          str(run_toml), "--raw_path", str(raw), "--workdir", str(workdir),
                          "--device", dev.type],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    cli_out = json.loads(cli.stdout.strip().splitlines()[-1]) if cli.returncode == 0 else {}
    log(f"applecider-serve-torch subprocess: exit {cli.returncode} in "
        f"{time.perf_counter() - t0:.1f} s (process start, model load and serving): {cli_out}")
    if cli.returncode != 0 or cli_out.get("n_alerts") != n_alerts:
        raise SystemExit(f"the serving CLI failed or served another count:\n{cli.stderr[-3000:]}")

    # 6. warmup, twice
    totals = []
    for which in ("first", "second"):
        w = rt.warmup()
        totals.append(w["total_seconds"])
        per = [p["seconds"] for p in w["programs"]]
        log(f"warmup ({which} in this process): {len(w['programs'])} shapes (length buckets x "
            f"spectra buckets, batch {w['programs'][0]['batch']}) in {w['total_seconds']:.2f} s, "
            f"kernel build check {w['build_seconds']:.2f} s, per shape {min(per):.3f}-"
            f"{max(per):.3f} s [{card}]")
    result["warmup_s"] = totals
    if on_card:
        torch.cuda.empty_cache()
    result["runtime"] = rt
    return result


# ------------------------------------------------------------- phase 7
# launches per photometry step: K4 forward and backward in each of the 4
# attention layers, nothing else; per validation or inference batch (no
# autograd): K2 in each attention layer
PHOTOMETRY_STEP_KERNELS = {"flash_attention_fwd": 4, "flash_attention_bwd": 4}


def _require_launches(launches: dict, want: dict, what: str, on_card: bool) -> None:
    """Exactly ``want``'s launches of each kernel it names, none of any
    other; the counts are logged on any device and held on the card."""
    wrong = {n: (launches[n], w) for n, w in want.items() if launches[n] != w}
    stray = [n for n in launches if n not in want and launches[n]]
    log(f"  launches in {what}: { {n: v for n, v in launches.items() if v} }")
    if on_card and (wrong or stray):
        raise SystemExit(f"{what} launches (got, expected): {wrong}; stray {stray}")


def _require_photometry_launches(launches: dict, steps: int, eval_batches: int, what: str,
                                 on_card: bool) -> None:
    """K4 forward and backward 4 a step, K2 4 an evaluation batch, no other
    kernel."""
    want = {n: per * steps for n, per in PHOTOMETRY_STEP_KERNELS.items()}
    want["masked_attention"] = EVAL_KERNELS["masked_attention"] * eval_batches
    _require_launches(launches, want, f"{what} ({steps} steps, {eval_batches} evaluation batches)",
                      on_card)


def _photometry_tasks():
    from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
    from applecider_tpu_torch.models.mpt import MPTTask

    return (("MPT", MPTTask), ("BaselineCLS", BaselineCLSTask))


def _photometry_batches(n_batches: int, batch_size: int, seed: int) -> list:
    """``BaselineCLSTask.to_tensor`` batches of ``SyntheticFusionDataset``
    light curves: U(8, 257) events with one-hot bands, labels in [0, 5)."""
    from applecider_tpu_torch.models.baseline_cls import BaselineCLSTask
    from applecider_tpu_torch.testing import SyntheticFusionDataset

    data = SyntheticFusionDataset(n_batches * batch_size, seed=seed)
    return [BaselineCLSTask.to_tensor(data.collate([data.sample(i) for i in range(s, s + batch_size)]))
            for s in range(0, n_batches * batch_size, batch_size)]


def _staged_steps(trainer, batches: list, steps: int, on_card: bool) -> dict:
    """``steps`` train steps over ``batches`` (already on the device), in
    turn, after one step of first launches: each timed with CUDA events
    (the host clock on the CPU); the launches of the timed steps alone;
    the peak device memory over them."""
    import torch

    trainer.train_step(batches[0])
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counters = zero_counters()
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        m = trainer.train_step(batches[i % len(batches)])
        if on_card:
            ev[1].record()
            times.append(ev)
        else:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    if on_card:
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in times]
    launches = _kernel_launches(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    losses = [float(x) for x in losses]
    med = float(np.median(times))
    batch_size = len(batches[0][0])
    return {"step_ms": times, "median_ms": med, "samples_per_s": batch_size / med * 1e3,
            "peak_gib": peak, "launches": launches, "losses": losses, "batch": batch_size}


def _log_staged(what: str, r: dict, card: str) -> None:
    log(f"{what}, batch {r['batch']}, staged: ms {', '.join(f'{t:.3f}' for t in r['step_ms'])}; "
        f"median {r['median_ms']:.3f} ms, {r['samples_per_s']:.1f} samples/s; peak memory "
        f"{r['peak_gib']:.2f} GiB; losses {[round(x, 4) for x in r['losses']]} [{card}]")
    if not all(np.isfinite(r["losses"])):
        raise SystemExit(f"{what}: a loss is not finite")


def photometry_staged_steps(card: str, workdir: Path, cfg, dev, batch_size: int = 256,
                            steps: int = 5) -> dict:
    """Phase 7a: ``steps`` MPT and classifier steps on batches already on the
    card (``_staged_steps``)."""
    import torch

    from applecider_tpu_torch.train.trainer import Trainer

    on_card = dev.type == "cuda"
    hosts = _photometry_batches(2, batch_size, seed=5)
    out = {}
    for name, cls in _photometry_tasks():
        task = cls(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(task, cfg, workdir / name, device=dev)
        r = _staged_steps(trainer, [trainer.to_device(h) for h in hosts], steps, on_card)
        _log_staged(f"photometry {name} steps, {cfg.get_path('train.compute_dtype')}, d_model "
                    f"{cfg.get_path('model.BaselineCLS.d_model')} x "
                    f"{cfg.get_path('model.BaselineCLS.n_layers')} layers", r, card)
        _require_photometry_launches(r["launches"], steps, 0, f"the {name} steps", on_card)
        out[name] = r
        del trainer, task
    return out


def photometry_parity(workdir: Path, dev, batch_size: int = 32,
                      model_overrides: dict | None = None) -> dict:
    """Phase 7b: one f32 MPT step and one classifier step (TF32 off, dropout
    live) on the kernel path and the plain path, with the same weights, the
    same dropout draws (equal generators) and so the same MPT mask; phase
    5's limits: |dloss| <= 1e-5, each gradient within 1e-4 * max(1, max|g|),
    parameters after the step within 1e-6 where |g| >= max(1e-5, tol) and
    within 2 * lr + 1e-7 elsewhere (Adam's first step moves an entry whose
    two gradients differ in sign, which only one below the tolerance can,
    by up to 2 * lr: the attention's key bias, whose gradient is zero but
    for rounding, is such an entry). Then the classifier's eval logits, K2
    against its plain version on the same weights, within 1e-4."""
    import torch

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.train.trainer import Trainer

    cfg = load_defaults().merged_with(model_overrides or {})
    cfg.set("train.compute_dtype", "float32")
    host = _photometry_batches(1, batch_size, seed=6)[0]
    out = {}
    for name, cls in _photometry_tasks():
        task_k = cls(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        task_p = copy.deepcopy(task_k)
        steps = {}
        for path, task, kernels in (("kernel", task_k, True), ("plain", task_p, False)):
            trainer = Trainer(task, cfg, workdir / f"{name}_{path}", device=dev, seed=11)
            with no_tf32():
                m = trainer.train_step(trainer.to_device(host), kernels=kernels)
            lr = trainer.optimizer.param_groups[0]["lr"]
            steps[path] = (float(m["loss"]), {n: p.grad.detach().clone()
                                              for n, p in task.module.named_parameters()})
        (lk, gk), (lp, gp) = steps["kernel"], steps["plain"]
        ok = abs(lk - lp) <= 1e-5
        g_err, p_err, worst = 0.0, 0.0, ""
        for (n, pk), pp in zip(task_k.module.named_parameters(), task_p.module.parameters()):
            d = (gk[n] - gp[n]).abs().max().item()
            lim = 1e-4 * max(1.0, gp[n].abs().max().item())
            if d / lim > g_err:
                g_err, worst = d / lim, n
            dp = (pk.detach() - pp.detach()).abs()
            big = gp[n].abs() >= max(1e-5, lim)
            p_err = max(p_err, float(dp[big].max()) if big.any() else 0.0)
            ok = ok and d <= lim and bool((dp[big] <= 1e-6).all()) and \
                bool((dp <= 2 * lr + 1e-7).all())
        log(f"photometry {name} f32 step (TF32 off, dropout live, batch {batch_size}), kernel vs "
            f"plain: loss {lk:.7f} vs {lp:.7f} (|d| {abs(lk - lp):.3g} <= 1e-5); worst gradient "
            f"at {g_err:.3g} of its bound ({worst}); post-step params max|d| where |g| >= "
            f"max(1e-5, tol) {p_err:.3g} (<= 1e-6) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the f32 {name} step disagrees between the kernel and plain paths")
        out[name] = {"loss_err": abs(lk - lp), "grad_err_of_bound": g_err, "param_err": p_err}
        if name == "BaselineCLS":
            batch = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host)
            with torch.no_grad(), no_tf32():
                err = float((task_k.predict(batch) - task_k.predict(batch, kernels=False))
                            .abs().max())
            log(f"photometry classifier f32 eval logits, K2 vs plain on the same weights: "
                f"max|d| {err:.3g} (<= 1e-4)")
            if not err <= 1e-4:
                raise SystemExit("the classifier's eval logits disagree between K2 and plain")
            out[name]["eval_logit_err"] = err
    return out


def photometry_protocol(card: str, tmp: Path, dev, n_objects: int = 100, batch_size: int = 32,
                        model_overrides: dict | None = None) -> dict:
    """Phase 7c: the reference recipe through the user's entry points, on a
    learnable ``make_corpus`` corpus that ``preprocess_data`` builds:
    ``AppleCiderRuntime("configs/photometry.toml")`` with ``model.name =
    "MPT"`` for 2 epochs -> ``warmstart_classifier_params`` -> the
    classifier with ``train.freeze_params = ["trunk"]`` for 1 epoch
    (``train(init_params=)``) -> unfrozen with plateau 0.5, accumulation 2
    and EMA 0.99 for 2 epochs -> ``infer``."""
    import torch

    from applecider_tpu_torch.datasets.photo_dataset import PhotoEventsDataset
    from applecider_tpu_torch.models.mpt import warmstart_classifier_params
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    raw, labels = make_corpus(tmp, n_objects=n_objects, seed=13, learnable=True, n_photometry=50,
                              n_alerts=3)
    out = tmp / "out"
    preprocess_data(str(raw), str(labels), str(out), min_per_class=2, seed=42)
    log(f"photometry protocol corpus: {n_objects} learnable objects (50 points, 3 alerts) written "
        f"and preprocessed in {time.perf_counter() - t0:.1f} s")
    overrides = {"data_loader": {"batch_size": batch_size},
                 "data_set": {PhotoEventsDataset.SECTION: {
                     "manifest_path": str(out / "manifest_train.csv"),
                     "stats_path": str(out / "photo_stats.npz")}},
                 **(model_overrides or {})}

    def run(what: str, settings: dict, init_params=None):
        rt = AppleCiderRuntime(REPO / "configs" / "photometry.toml", overrides,
                               workdir=tmp / "results", device=dev)
        for key, value in settings.items():
            rt.set_config(key, value)
        rt.prepare()
        counters = zero_counters()
        t0 = time.perf_counter()
        res = rt.train(init_params=init_params)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _kernel_launches(counters)
        history = res["history"]
        steps = history[-1]["steps"]
        val_batches = len(rt._loader(rt.datasets["validate"], shuffle=False)) * len(history)
        log(f"{what}: {len(history)} epochs, {steps} steps of {batch_size} in {wall:.2f} s; "
            f"train_loss {[round(r['train_loss'], 4) for r in history]}, val_loss "
            f"{[round(r['val_loss'], 4) for r in history]} [{card}]")
        _require_photometry_launches(launches, steps, val_batches, what, on_card)
        if not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in history):
            raise SystemExit(f"{what}: a loss is not finite")
        ckpts = {t: (res["run_dir"] / "checkpoints" / f"{t}.pt") for t in ("best", "last")}
        if not all(p.exists() for p in ckpts.values()):
            raise SystemExit(f"{what}: best.pt or last.pt missing")
        last = torch.load(ckpts["last"], map_location=dev, weights_only=True)
        return rt, res, last, launches

    result: dict = {"launches": {}}
    _, mpt, mpt_last, result["launches"]["mpt"] = run(
        "runtime train, photometry.toml with model.name = MPT (pretrain_lr 1e-3)",
        {"model.name": "MPT", "model.BaselineCLS.pretrain_lr": 1e-3, "train.epochs": 2})
    mpt_losses = [r["train_loss"] for r in mpt["history"]]
    if not mpt_losses[-1] < mpt_losses[0]:
        raise SystemExit(f"the MPT loss did not fall: {mpt_losses}")

    frozen_settings = {"train.freeze_params": ["trunk"], "train.epochs": 1}
    rt = AppleCiderRuntime(REPO / "configs" / "photometry.toml", overrides,
                           workdir=tmp / "results", device=dev)
    warm = warmstart_classifier_params(rt._task().module.state_dict(), mpt_last["params"])
    _, frozen, frozen_last, result["launches"]["frozen"] = run(
        "runtime train, classifier warm-started, trunk frozen", frozen_settings, warm)
    moved = [n for n, v in frozen_last["params"].items()
             if n.startswith("trunk.") and not torch.equal(v, warm[n].to(v.device))]
    heads = [n for n, v in frozen_last["params"].items()
             if not n.startswith("trunk.") and not torch.equal(v, warm[n].to(v.device))]
    log(f"  trunk tensors moved in the frozen epoch: {len(moved)} (0 required); head tensors "
        f"moved: {len(heads)}")
    if moved or not heads:
        raise SystemExit("the frozen epoch moved the trunk, or did not train the head")

    rt, full, _, result["launches"]["unfrozen"] = run(
        "runtime train, classifier unfrozen, plateau 0.5, accumulation 2, EMA 0.99",
        {"train.plateau_factor": 0.5, "train.grad_accum_steps": 2, "train.ema_decay": 0.99,
         "train.epochs": 2}, frozen_last["params"])
    report = {k: v for k, v in full["history"][-1].items() if k.startswith("val_") or k == "lr_scale"}
    log(f"  the last epoch's report: {json.dumps(report)}")
    counters = zero_counters()
    preds = rt.infer()
    infer_batches = len(rt._loader(rt.datasets["infer"], shuffle=False))
    result["launches"]["infer"] = _kernel_launches(counters)
    log(f"runtime infer: predictions {preds.shape}, finite {bool(np.isfinite(preds).all())}")
    _require_photometry_launches(result["launches"]["infer"], 0, infer_batches, "runtime infer",
                                 on_card)
    if preds.ndim != 2 or preds.shape[1] != 5 or not len(preds) or not np.isfinite(preds).all():
        raise SystemExit("runtime infer did not return finite (n, 5) predictions")
    result.update(mpt_losses=mpt_losses, report=report)
    return result


def check_photometry(card: str, device="cuda", model_overrides: dict | None = None,
                     batch_size: int = 256, n_objects: int = 100) -> dict:
    """Phase 7: the photometry model family at the published widths in bf16
    (7a staged steps, 7c the protocol) and in f32 (7b parity). ``device``,
    ``model_overrides`` (e.g. small widths), ``batch_size`` and
    ``n_objects`` are for a dry run on the CPU."""
    import tempfile

    import torch

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cfg = load_defaults().merged_with(model_overrides or {})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_photometry_") as tmp:
        tmp = Path(tmp)
        staged = photometry_staged_steps(card, tmp / "staged", cfg, dev, batch_size)
        parity = photometry_parity(tmp / "parity", dev, model_overrides=model_overrides)
        protocol = photometry_protocol(card, tmp, dev, n_objects=n_objects,
                                       model_overrides=model_overrides)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def summed(runs):
        return {n: sum(r[n] for r in runs) for n in runs[0]}

    return {"staged": staged, "parity": parity, "protocol": protocol,
            "staged_launches": summed([s["launches"] for s in staged.values()]),
            "protocol_launches": summed(list(protocol["launches"].values()))}


# ------------------------------------------------------------- phase 8
# launches per SpectraNet step: K3 forward and backward in each of its 5
# blocks, nothing else; per inference batch (no autograd): K3f 5. TriPool
# and AstroMiNN launch no port kernel.
SPECTRA_STEP_KERNELS = {"ln_gelu_fwd": 5, "ln_gelu_bwd": 5}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms (its default weight gradients sum
    with atomics in any order), for a step that must repeat bit for bit."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _spectra_batch(rng, batch_size: int, length: int = 3481) -> tuple:
    """``SpectraNetTask.to_tensor`` arrays: N(0, 1) flux, labels in [0, 9),
    redshifts U(0, 0.3)."""
    return (rng.normal(size=(batch_size, length)).astype(np.float32),
            rng.integers(0, 9, size=batch_size).astype(np.int64),
            rng.uniform(0.0, 0.3, size=batch_size).astype(np.float32))


def _astrominn_batch(rng, batch_size: int) -> tuple:
    """``AstroMiNNTask.to_tensor`` arrays: metadata (B, 24), NHWC 63 x 63
    cutouts, one-hot targets of 5 classes."""
    return (rng.normal(size=(batch_size, 24)).astype(np.float32),
            rng.normal(size=(batch_size, 63, 63, 3)).astype(np.float32),
            np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=batch_size)])


def _single_tasks(cfgs: dict) -> list:
    """(what, task class, config, host batches, launches a step) of phase
    8a's runs."""
    from applecider_tpu_torch.models.astrominn import AstroMiNNTask
    from applecider_tpu_torch.models.spectranet import SpectraNetTask, SpectraNetTriPoolTask

    rng = np.random.default_rng(21)
    sb = int(cfgs["spectra"].get_path("data_loader.batch_size"))
    ab = int(cfgs["astrominn"].get_path("data_loader.batch_size"))
    spectra = [_spectra_batch(rng, sb) for _ in range(2)]
    redshift = cfgs["spectra"].merged_with({"model": {"SpectraNet": {"redshift": True}}})
    return [("SpectraNet classifier", SpectraNetTask, cfgs["spectra"], spectra,
             SPECTRA_STEP_KERNELS),
            ("SpectraNet redshift", SpectraNetTask, redshift, spectra, SPECTRA_STEP_KERNELS),
            ("SpectraNetTriPool", SpectraNetTriPoolTask, cfgs["spectra"], spectra, {}),
            ("AstroMiNN", AstroMiNNTask, cfgs["astrominn"],
             [_astrominn_batch(rng, ab) for _ in range(2)], {})]


def single_staged_steps(card: str, workdir: Path, cfgs: dict, dev, steps: int = 5) -> dict:
    """Phase 8a: ``steps`` staged bf16 steps of each single-modality task at
    its config's batch (``_staged_steps``)."""
    import torch

    from applecider_tpu_torch.train.trainer import Trainer

    on_card = dev.type == "cuda"
    out = {}
    for what, cls, cfg, hosts, per_step in _single_tasks(cfgs):
        task = cls(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        trainer = Trainer(task, cfg, workdir / what.replace(" ", "_"), device=dev)
        r = _staged_steps(trainer, [trainer.to_device(h) for h in hosts], steps, on_card)
        n_params = sum(p.numel() for p in task.module.parameters())
        _log_staged(f"{what} steps, {cfg.get_path('train.compute_dtype')}, {n_params:,} "
                    f"parameters", r, card)
        _require_launches(r["launches"], {n: k * steps for n, k in per_step.items()},
                          f"the {what} steps ({steps})", on_card)
        out[what] = r
        del trainer, task
    if on_card:
        torch.cuda.empty_cache()
    return out


def _perturb_batchnorm(module, seed: int) -> None:
    """Frozen BatchNorm statistics off their init (mean 0, var 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in module.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.2 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)


def single_parity(workdir: Path, cfgs: dict, dev, batch_size: int = 32) -> dict:
    """Phase 8b, f32, TF32 off, dropout live, the same weights and draws
    (``Trainer(seed=11)``): one SpectraNet step on the kernel path against
    the plain path within phase 5's limits (|dloss| <= 1e-5; the stages,
    behind max pools, ||dg|| <= 5e-2 ||g||; the head's gradients within
    1e-4 * max(1, max|g|); parameters within 1e-6 where |g| >= max(1e-5,
    tol), and every one within 2 * lr + 1e-7), then its eval logits
    (<= 1e-4); one TriPool step (the reference's BatchNorm stages, their
    statistics perturbed) and one AstroMiNN step, which have no kernel,
    each run twice and equal bit for bit (cuDNN deterministic), the
    BatchNorm statistics unchanged."""
    import torch

    from applecider_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(22)
    out = {}
    runs = _single_tasks({k: c.merged_with({"train": {"compute_dtype": "float32"}})
                          for k, c in cfgs.items()})
    for what, cls, cfg, _, _ in (r for r in runs if r[0] != "SpectraNet redshift"):
        if what == "SpectraNetTriPool":
            cfg = cfg.merged_with({"model": {"SpectraNetTriPool": {
                "use_ln_stages": [False, False, False, False, True]}}})
        host = (_astrominn_batch(rng, batch_size) if what == "AstroMiNN"
                else _spectra_batch(rng, batch_size))
        task_a = cls(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        _perturb_batchnorm(task_a.module, 1)
        task_b = copy.deepcopy(task_a)
        stats = {n: b.clone() for n, b in task_a.module.named_buffers() if "running" in n}
        kernels = what.startswith("SpectraNet ")
        steps = {}
        for path, task in (("a", task_a), ("b", task_b)):
            trainer = Trainer(task, cfg, workdir / f"{what.replace(' ', '_')}_{path}", device=dev,
                              seed=11)
            with no_tf32(), deterministic_cudnn():
                m = trainer.train_step(trainer.to_device(host),
                                       kernels=not (kernels and path == "b"))
            lr = trainer.optimizer.param_groups[0]["lr"]
            steps[path] = (float(m["loss"]), {n: p.grad.detach().clone()
                                              for n, p in task.module.named_parameters()})
        (la, ga), (lb, gb) = steps["a"], steps["b"]
        moved = [n for n, b in task_a.module.named_buffers() if n in stats
                 and not torch.equal(stats[n], b)]
        pa = dict(task_a.module.named_parameters())
        pb = dict(task_b.module.named_parameters())
        if not kernels:
            same = la == lb and all(torch.equal(ga[n], gb[n]) and torch.equal(pa[n], pb[n])
                                    for n in pa)
            log(f"{what} f32 step (TF32 off, dropout live, batch {batch_size}) run twice: loss "
                f"{la:.7f} and {lb:.7f}; loss, gradients and parameters bit for bit: {same}; "
                f"BatchNorm statistics {len(stats)}, moved {moved}")
            if not same or moved:
                raise SystemExit(f"the {what} step is not deterministic, or it moved its "
                                 "frozen BatchNorm statistics")
            out[what] = {"bitwise": same, "frozen_stats": len(stats)}
            continue
        ok = abs(la - lb) <= 1e-5
        g_err, s_err, p_err, worst = 0.0, 0.0, 0.0, ""
        for n in pa:
            dp = (pa[n].detach() - pb[n].detach()).abs()
            ok = ok and bool((dp <= 2 * lr + 1e-7).all())
            if n.startswith("stage"):
                rel = float((ga[n] - gb[n]).norm()) / max(float(gb[n].norm()), 1e-12)
                s_err = max(s_err, rel)
                ok = ok and rel <= 5e-2
                continue
            d = (ga[n] - gb[n]).abs().max().item()
            lim = 1e-4 * max(1.0, gb[n].abs().max().item())
            if d / lim > g_err:
                g_err, worst = d / lim, n
            big = gb[n].abs() >= max(1e-5, lim)
            p_err = max(p_err, float(dp[big].max()) if big.any() else 0.0)
            ok = ok and d <= lim and bool((dp[big] <= 1e-6).all())
        batch = tuple(torch.from_numpy(a).to(dev) for a in host)
        with torch.no_grad(), no_tf32():
            logit_err = float((task_a.predict(batch) - task_a.predict(batch, kernels=False))
                              .abs().max())
        ok = ok and logit_err <= 1e-4
        log(f"{what} f32 step (TF32 off, dropout live, batch {batch_size}), kernel vs plain: "
            f"loss {la:.7f} vs {lb:.7f} (|d| {abs(la - lb):.3g} <= 1e-5); stages ||dg||/||g|| "
            f"{s_err:.3g} (<= 5e-2); head gradient at {g_err:.3g} of its bound ({worst}); "
            f"post-step params max|d| where |g| >= max(1e-5, tol) {p_err:.3g} (<= 1e-6); eval "
            f"logits, K3f vs plain, max|d| {logit_err:.3g} (<= 1e-4) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the f32 {what} step or logits disagree between the kernel and "
                             "plain paths")
        out[what] = {"loss_err": abs(la - lb), "stage_rel_grad_err": s_err,
                     "grad_err_of_bound": g_err, "param_err": p_err, "eval_logit_err": logit_err}
    return out


def write_spectra_table(path: Path, n: int, seed: int, length: int = 3481) -> Path:
    """A learnable ``SpectraDataset`` table: N(0, 0.5) flux (B, 1, L) with a
    Gaussian line whose height (1 + c / 2) and place are set by the class
    c, each of the 9 labels as named in ``LABEL_STRINGS``, redshifts
    U(0, 0.3)."""
    from applecider_tpu_torch.datasets.spectra_dataset import LABEL_STRINGS

    rng = np.random.default_rng(seed)
    names = list(LABEL_STRINGS)
    cls = rng.integers(0, len(names), size=n)
    bins = np.arange(length)
    centre = (cls + 1) * length / (len(names) + 1)
    flux = rng.normal(0.0, 0.5, size=(n, 1, length))
    line = np.exp(-0.5 * ((bins[None, :] - centre[:, None]) / 20.0) ** 2)  # 20 bins wide
    flux[:, 0] += (1.0 + cls[:, None] / 2.0) * line
    np.savez(path, flux=flux.astype(np.float32),
             labels=np.asarray([names[c] for c in cls], dtype=object),
             redshifts=rng.uniform(0.0, 0.3, size=n).astype(np.float32),
             file_paths=np.asarray([f"spec_{i}.fits" for i in range(n)], dtype=object))
    return path


def _runtime_train(what: str, config: str, overrides: dict, workdir: Path, dev, card: str,
                   settings: dict | None = None):
    """``AppleCiderRuntime(configs/<config>)`` with ``settings`` set:
    ``prepare`` and ``train``; returns (runtime, result, the training's
    launches)."""
    import torch

    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    rt = AppleCiderRuntime(REPO / "configs" / config, overrides, workdir=workdir, device=dev)
    for key, value in (settings or {}).items():
        rt.set_config(key, value)
    rt.prepare()
    counters = zero_counters()
    t0 = time.perf_counter()
    res = rt.train()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernel_launches(counters)
    history = res["history"]
    log(f"{what}: {len(history)} epochs, {history[-1]['steps']} steps of "
        f"{rt.config.get_path('data_loader.batch_size')} in {wall:.2f} s; train_loss "
        f"{[round(r['train_loss'], 4) for r in history]} [{card}]")
    if not all(np.isfinite(r["train_loss"]) for r in history):
        raise SystemExit(f"{what}: a loss is not finite")
    return rt, res, launches


def _runtime_infer(what: str, rt, shape_tail: tuple, want_per_batch: dict, on_card: bool):
    """``rt.infer()``: finite predictions of (n, *shape_tail) and exactly
    ``want_per_batch`` launches an inference batch; returns the launches."""
    counters = zero_counters()
    preds = rt.infer()
    launches = _kernel_launches(counters)
    batches = len(rt._loader(rt.datasets["infer"], shuffle=False))
    log(f"{what} infer: predictions {preds.shape}, finite {bool(np.isfinite(preds).all())}")
    _require_launches(launches, {n: k * batches for n, k in want_per_batch.items()},
                      f"{what} infer ({batches} batches)", on_card)
    if preds.shape[1:] != shape_tail or not len(preds) or not np.isfinite(preds).all():
        raise SystemExit(f"{what} infer did not return finite (n, *{shape_tail}) predictions")
    return launches


def single_protocol(card: str, tmp: Path, dev, n_spectra: int = 256, n_objects: int = 64,
                    model_overrides: dict | None = None) -> dict:
    """Phase 8c, through the user's entry points: ``configs/spectra.toml``
    on a learnable table (2 epochs, the loss falls; again as the redshift
    regressor for 1 epoch), ``configs/astrominn.toml`` on the samples
    ``build_alert_samples`` writes from a ``preprocess_data`` corpus (2
    epochs, oversampled; 6 alerts an object at most, the cap of the
    reference's alert pipeline), and ``configs/fusion.toml`` with the TriPool
    spectra encoder on that corpus (1 epoch, then ``serve`` against
    ``serve_alert_stream`` on ``best.pt``)."""
    import torch

    from applecider_tpu_torch.datasets.photo_dataset import load_photo_stats
    from applecider_tpu_torch.datasets.spectra_dataset import SpectraDataset
    from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.ops import merge_scan
    from applecider_tpu_torch.preprocessing.alert_samples import build_alert_samples
    from applecider_tpu_torch.preprocessing.cli import preprocess_data
    from applecider_tpu_torch.testing import make_corpus

    on_card = dev.type == "cuda"
    result: dict = {"launches": {}}
    table = write_spectra_table(tmp / "spectra.npz", n_spectra, seed=23)
    overrides = {"model_inputs": {p: {"data": {"data_location": str(table)}}
                                  for p in ("train", "infer")},
                 **(model_overrides or {})}
    rt, res, launches = _runtime_train(
        "runtime train, spectra.toml (lr 1e-3)", "spectra.toml", overrides, tmp / "spectra", dev,
        card, {"train.epochs": 2, "model.SpectraNet.lr": 1e-3})
    steps = res["history"][-1]["steps"]
    _require_launches(launches, {n: k * steps for n, k in SPECTRA_STEP_KERNELS.items()},
                      f"runtime train, spectra.toml ({steps} steps)", on_card)
    losses = [r["train_loss"] for r in res["history"]]
    if not losses[-1] < losses[0]:
        raise SystemExit(f"the SpectraNet loss did not fall: {losses}")
    result["launches"]["spectra"] = launches
    result["launches"]["spectra_infer"] = _runtime_infer("spectra.toml", rt, (9,),
                                                         {"ln_gelu_fwd": 5}, on_card)
    rt, res, launches = _runtime_train(
        "runtime train, spectra.toml with model.SpectraNet.redshift = true", "spectra.toml",
        overrides, tmp / "redshift", dev, card,
        {"train.epochs": 1, "model.SpectraNet.redshift": True})
    steps = res["history"][-1]["steps"]
    _require_launches(launches, {n: k * steps for n, k in SPECTRA_STEP_KERNELS.items()},
                      f"runtime train, redshift ({steps} steps)", on_card)
    result["launches"]["redshift"] = launches
    result["launches"]["redshift_infer"] = _runtime_infer("spectra.toml redshift", rt, (),
                                                          {"ln_gelu_fwd": 5}, on_card)
    result["spectra_losses"] = losses
    if not isinstance(rt.datasets["train"], SpectraDataset):
        raise SystemExit("spectra.toml did not bind SpectraDataset")

    t0 = time.perf_counter()
    raw, labels = make_corpus(tmp, n_objects=n_objects, seed=17, learnable=True,
                              n_photometry=(20, 60), spectrum_frac=0.3, n_alerts=4)
    out = tmp / "out"
    preprocess_data(str(raw), str(labels), str(out), min_per_class=2, seed=42)
    index = build_alert_samples(out / "manifest_train.csv", tmp / "samples", max_per_object=6)
    log(f"single-family corpus: {n_objects} learnable objects (20-60 points, 4 alerts) written, "
        f"preprocessed and {len(index)} alert samples built in {time.perf_counter() - t0:.1f} s")
    samples = {"model_inputs": {p: {"data": {"data_location": str(tmp / "samples")}}
                                for p in ("train", "infer")},
               **(model_overrides or {})}
    rt, res, launches = _runtime_train("runtime train, astrominn.toml (oversampled)",
                                       "astrominn.toml", samples, tmp / "astrominn", dev, card,
                                       {"train.epochs": 2})
    _require_launches(launches, {}, "runtime train, astrominn.toml", on_card)
    log(f"  ImageAndMetadataDataset: {len(rt.datasets['train'].records)} samples, "
        f"{len(rt.datasets['train'])} oversampled")
    result["launches"]["astrominn"] = launches
    result["launches"]["astrominn_infer"] = _runtime_infer("astrominn.toml", rt, (5,), {},
                                                           on_card)

    section = "applecider_tpu.datasets.fusion_dataset.FusionDataset"
    fusion = {"data_loader": {"batch_size": 16},
              "data_set": {section: {"manifest_path": str(out / "manifest_train.csv"),
                                     "stats_event_path": str(out / "photo_stats.npz")}},
              **(model_overrides or {})}
    rt, res, launches = _runtime_train(
        "runtime train, fusion.toml with model.AppleCider.spectra_encoder = tripool",
        "fusion.toml", fusion, tmp / "fusion", dev, card,
        {"train.epochs": 1, "model.AppleCider.spectra_encoder": "tripool"})
    steps = res["history"][-1]["steps"]
    val_batches = len(rt._loader(rt.datasets["validate"], shuffle=False))
    want = {n: per * steps for n, per in PHOTOMETRY_STEP_KERNELS.items()}
    want["masked_attention"] = EVAL_KERNELS["masked_attention"] * val_batches
    _require_launches(launches, want, f"the TriPool fusion training ({steps} steps, {val_batches} "
                      "validation batches)", on_card)
    result["launches"]["fusion"] = launches
    counters = zero_counters()
    walked = merge_scan.walked_rows(dev) if on_card else torch.zeros(1)
    walked.zero_()
    served = rt.serve(raw_path=raw)
    serve_launches = _kernel_launches(counters)
    log(f"runtime serve, TriPool fusion: {served['n_alerts']} alerts at "
        f"{served['alerts_per_sec']:.1f} alerts/s, host reading included [{card}]; K1 rows "
        f"walked {int(walked.item())} (0 required)")
    log(f"  launches in that run: { {n: v for n, v in serve_launches.items() if v} }")
    # K1 and K2 serve the light curves; TriPool has no kernel, so no K3f
    missing = [n for n in ("merge_scan", "masked_attention") if not serve_launches[n]]
    stray = [n for n, v in serve_launches.items()
             if v and n not in ("merge_scan", "masked_attention")]
    if on_card and (missing or stray or walked.item()):
        raise SystemExit(f"the TriPool fusion serving run: never launched {missing}, launched "
                         f"{stray}, or K1 walked {int(walked.item())} rows")
    model = build_fusion_model(rt.config, device=dev)
    model.load_state_dict(torch.load(res["run_dir"] / "checkpoints" / "best.pt",
                                     map_location=dev, weights_only=True)["params"])
    mean, std = load_photo_stats(out / "photo_stats.npz")
    sec = rt.config.section("serve")
    direct = serve_alert_stream(model, iter_alert_samples(raw), batch_size=sec["batch_size"],
                                length_buckets=tuple(sec["length_buckets"]), stats_mean=mean,
                                stats_std=std, horizon_days=100.0, device=dev)
    err = float(np.abs(np.stack([r["probs"] for r in served["results"]])
                       - np.stack([r["probs"] for r in direct["results"]])).max())
    log(f"  runtime serve vs serve_alert_stream on best.pt directly: max|dprob| {err:.3g} "
        f"(<= 1e-6 required)")
    if served["n_alerts"] != direct["n_alerts"] or not err <= 1e-6:
        raise SystemExit("the TriPool fusion serving run disagrees with serve_alert_stream")
    result["launches"]["serve"] = serve_launches
    result.update(serve_err=err, alerts_per_s=served["alerts_per_sec"])
    return result


def check_single_families(card: str, device="cuda", model_overrides: dict | None = None,
                          n_spectra: int = 256, n_objects: int = 64) -> dict:
    """Phase 8: the spectra and image+metadata families at the published
    widths in bf16 (8a staged steps, 8c the entry points) and in f32 (8b
    parity). ``device``, ``model_overrides`` (e.g. small widths) and the
    data sizes are for a dry run on the CPU."""
    import tempfile

    import torch

    from applecider_tpu_torch.config import load_config
    from applecider_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    cfgs = {k: load_config(REPO / "configs" / f"{k}.toml", model_overrides)
            for k in ("spectra", "astrominn")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_single_") as tmp:
        tmp = Path(tmp)
        staged = single_staged_steps(card, tmp / "staged", cfgs, dev)
        parity = single_parity(tmp / "parity", cfgs, dev)
        protocol = single_protocol(card, tmp, dev, n_spectra, n_objects, model_overrides)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"staged": staged, "parity": parity, "protocol": protocol,
            "staged_launches": {n: sum(r["launches"][n] for r in staged.values())
                                for n in kernel_counters()},
            "protocol_launches": {n: sum(r[n] for r in protocol["launches"].values())
                                  for n in kernel_counters()}}


# ------------------------------------------------------------- phase 9
OP_NAMES = {"merge_scan": "seg_ids", "masked_attention": "masked_attention",
            "ln_gelu_fwd": "ln_gelu_fwd"}


def _program_ops(path: Path) -> dict:
    """How many nodes of a saved program's graph call each kernel's op,
    read from the graph the archive serialises (``models/model.json``: the
    nodes ``torch.export.load`` rebuilds, without its seconds of rebuilding
    them)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        name = next(n for n in z.namelist() if n.endswith("models/model.json"))
        nodes = json.loads(z.read(name))["graph_module"]["graph"]["nodes"]
    targets = [n["target"] for n in nodes]
    return {k: targets.count(f"torch.ops.applecider_torch.{op}.default")
            for k, op in OP_NAMES.items()}


def _program_kernels(cfg, serving: bool = True) -> dict:
    """Launches per call of a program of the fusion model of ``cfg``: K1
    once (serving programs only), K2 in each attention layer, K3f in each
    SpectraNet block (4 and 5 at the published widths)."""
    n_layers = int(cfg.get_path("model.BaselineCLS.n_layers"))
    n_blocks = sum(cfg.get_path("model.SpectraNet.depths"))
    return {"merge_scan": int(serving), "masked_attention": n_layers, "ln_gelu_fwd": n_blocks}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _require_program_launches(launches: dict, calls: int, per_call: dict, what: str) -> None:
    """Each kernel of ``per_call`` launched that many times a program call,
    and no other kernel."""
    want = {k: v * calls for k, v in per_call.items()}
    got = {k: launches[k] for k in want}
    stray = [k for k in launches if k not in want and launches[k]]
    if got != want or stray:
        raise SystemExit(f"{what}: launches {got}, expected {want} ({calls} calls); stray {stray}")


def check_native_decoder(card: str, model, model32, raw: dict) -> dict:
    """Phase 9a: the native decoder on phase 3b's corpus, bit for bit
    against ``decode_stamp``, then ``OverlappedServingFeeder`` in thread
    mode with 1, 2 and 4 workers on records carrying the corpus' stamps,
    against the serial router: in f32 with TF32 off within 1e-6, as phase
    3b holds it, and in bf16, the serving dtype, within 1e-3 (the merge's
    ``scatter_add_`` sums in the order its atomics land: ~3e-8 apart in
    f32, which bf16 rounding turns into up to ~2e-4)."""
    from applecider_tpu_torch import native
    from applecider_tpu_torch.infer.feeder import OverlappedServingFeeder, assemble_samples
    from applecider_tpu_torch.infer.serve import CUTOUT_KEYS
    from applecider_tpu_torch.infer.stream import LENGTH_BUCKETS, FusedSpectraStream
    from applecider_tpu_torch.preprocessing.fitsio import decode_stamp

    data_dir, pairs = raw["data_dir"], raw["pairs"]
    dev = next(model.parameters()).device
    n_stamps, differ = 0, []
    for obj in sorted(p.name for p in data_dir.iterdir()):
        blobs = [a[k]["stampData"] for a in np.load(data_dir / obj / "alerts.npy", allow_pickle=True)
                 for k in CUTOUT_KEYS]
        images, ok = native.decode_stamps_batch(blobs)
        for i, blob in enumerate(blobs):
            ref = decode_stamp(blob)
            good = ref is not None and ref.shape == (63, 63)
            if good != bool(ok[i]) or (good and images[i].tobytes() != ref.tobytes()):
                differ.append((obj, i))
        n_stamps += len(blobs)
    log(f"native decoder ({native.build_variant()} variant): {n_stamps} stamps of the raw corpus "
        f"decoded, {len(differ)} differing from decode_stamp bit for bit (0 required)")
    if differ:
        raise SystemExit(f"the native decoder differs from decode_stamp: {differ[:10]}")
    per_object = [[a[k]["stampData"] for a in np.load(data_dir / o / "alerts.npy", allow_pickle=True)
                   for k in CUTOUT_KEYS] for o in sorted(p.name for p in data_dir.iterdir())]
    decode_ms = {}
    for n_threads in (1, 2, 4, 8, 0):
        t0 = time.perf_counter()
        for blobs in per_object:
            native.decode_stamps_batch(blobs, n_threads=n_threads)
        decode_ms[n_threads] = (time.perf_counter() - t0) * 1e3
    log(f"native decode of the corpus' stamps, one call an object, ms by n_threads (0: the "
        f"{len(os.sched_getaffinity(0))} cores this process may use; os.cpu_count() "
        f"{os.cpu_count()}): {decode_ms} [{card}]")

    records = _stamp_records(pairs, data_dir)
    batches = [records[i:i + 512] for i in range(0, len(records), 512)]
    rates = {}
    for what, m, limit in (("f32", model32, 1e-6), ("bf16", model, 1e-3)):
        router = FusedSpectraStream(m, device=dev)
        with no_tf32() if what == "f32" else contextlib.nullcontext():
            _sync(dev)
            t0 = time.perf_counter()
            want = [router(assemble_samples(rb), length_buckets=LENGTH_BUCKETS) for rb in batches]
            rates[what] = {"serial": len(records) / (time.perf_counter() - t0)}
            for workers in (1, 2, 4):
                feeder = OverlappedServingFeeder(router, n_workers=workers, mode="thread",
                                                 length_buckets=LENGTH_BUCKETS)
                _sync(dev)
                t0 = time.perf_counter()
                got = list(feeder.serve(iter(batches)))
                rates[what][workers] = len(records) / (time.perf_counter() - t0)
                err = max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
                    if len(got) == len(want) else float("inf")
                log(f"OverlappedServingFeeder thread mode {what}, {workers} workers: {len(records)} "
                    f"records with stamps in {len(batches)} batches of 512, "
                    f"{rates[what][workers]:.1f} alerts/s (the serial router "
                    f"{rates[what]['serial']:.1f}); max|dprob| vs serial {err:.3g} (<= {limit:g} "
                    f"required) [{card}]")
                if not err <= limit:
                    raise SystemExit(f"OverlappedServingFeeder ({what}, {workers} workers) "
                                     "disagrees with the serial router")
    return {"variant": native.build_variant(), "stamps": n_stamps, "decode_ms": decode_ms,
            "feeder_alerts_per_s": rates}


def check_export_serving(card: str, model, model32, raw: dict, tmp: Path,
                         model_overrides: dict | None = None) -> dict:
    """Phase 9b: ``export_serving`` of phase 3's bf16 weights at every
    serving length bucket (each symbolic in batch, each graph holding K1
    x1, K2 x4, K3f x5), then ``engine_serving`` over phase 3b's corpus
    against ``serve_alert_stream`` on the same weights (bf16, <= 1e-3), in
    one call with it for alerts/s, the launch counters 1/4/5 a program
    call; and one f32 program (P = 257, TF32 off) against the live f32
    pipeline (<= 1e-5). ``model_overrides`` (small widths) is for a dry run
    on the CPU."""
    from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
    from applecider_tpu_torch.infer.stream import LENGTH_BUCKETS
    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    dev = next(model.parameters()).device
    on_card = dev.type == "cuda"
    data_dir, n = raw["data_dir"], len(raw["pairs"])

    def runtime(dtype):
        overrides = copy.deepcopy(model_overrides or {})
        overrides.setdefault("model", {})["name"] = "AppleCider"
        overrides["train"] = {"compute_dtype": dtype}
        return AppleCiderRuntime(overrides=overrides, workdir=tmp / "results", device=dev)

    rt = runtime("bfloat16")
    per_call = _program_kernels(rt.config)
    out = rt.export_serving(tmp / "serving_bf16", length_buckets=LENGTH_BUCKETS,
                            params=model.state_dict())
    meta = json.loads((out / "serving_meta.json").read_text())
    for P in LENGTH_BUCKETS:
        bmeta = meta["buckets"][str(P)]
        ops = _program_ops(out / f"serving_P{P}.pt2")
        log(f"export_serving bf16 P={P}: {bmeta['seconds']:.1f} s, symbolic batch "
            f"{bmeta['symbolic_batch']}, {(out / f'serving_P{P}.pt2').stat().st_size / 2**20:.1f} "
            f"MiB; custom-op nodes {ops} [{card}]")
        if not bmeta["symbolic_batch"]:
            raise SystemExit(f"bucket {P} fell back to a concrete batch: {bmeta['symbolic_error']}")
        if ops != per_call:
            raise SystemExit(f"the P={P} program holds {ops}, expected {per_call}")

    batch_size = 512
    _sync(dev)
    live = serve_alert_stream(model, iter_alert_samples(data_dir), batch_size=batch_size, device=dev)
    counters = zero_counters()
    engine = rt.engine_serving(out, raw_path=data_dir, batch_size=batch_size)
    launches = _kernel_launches(counters)
    calls = -(-n // batch_size)
    err = float(np.abs(np.stack([r["probs"] for r in engine["results"]])
                       - np.stack([r["probs"] for r in live["results"]])).max())
    log(f"engine_serving bf16 over the raw corpus: {engine['n_alerts']} alerts in "
        f"{engine['seconds']:.4f} s, {engine['alerts_per_sec']:.1f} alerts/s; serve_alert_stream "
        f"in the same call {live['alerts_per_sec']:.1f} alerts/s (both from the directories, "
        f"batch {batch_size}) [{card}]; max|dprob| {err:.3g} (<= 1e-3 required); launches "
        f"{launches} in {calls} program calls")
    if engine["n_alerts"] != n or [(r["object_id"], r["jd"]) for r in engine["results"]] != \
            [(r["object_id"], r["jd"]) for r in live["results"]] or not err <= 1e-3:
        raise SystemExit("engine_serving disagrees with serve_alert_stream in bf16")
    if on_card:
        _require_program_launches(launches, calls, per_call, "engine_serving")

    out32 = runtime("float32").export_serving(tmp / "serving_f32", length_buckets=(257,),
                                              params=model32.state_dict())
    with no_tf32():
        live32 = serve_alert_stream(model32, iter_alert_samples(data_dir), batch_size=batch_size,
                                    length_buckets=(257,), device=dev)
        engine32 = runtime("float32").engine_serving(out32, raw_path=data_dir,
                                                      batch_size=batch_size)
    err32 = float(np.abs(np.stack([r["probs"] for r in engine32["results"]])
                         - np.stack([r["probs"] for r in live32["results"]])).max())
    seconds32 = json.loads((out32 / "serving_meta.json").read_text())["buckets"]["257"]["seconds"]
    log(f"export_serving f32 P=257 in {seconds32:.1f} s; engine_serving f32 (TF32 off) vs the live "
        f"f32 pipeline: max|dprob| {err32:.3g} (<= 1e-5 required) [{card}]")
    if not err32 <= 1e-5:
        raise SystemExit("the f32 serving program disagrees with the live f32 pipeline")
    return {"launches": launches, "export_s": {P: meta["buckets"][str(P)]["seconds"]
                                                 for P in LENGTH_BUCKETS},
            "alerts_per_s": engine["alerts_per_sec"], "serve_alerts_per_s": live["alerts_per_sec"],
            "err_bf16": err, "err_f32": err32}


def check_export_engine(card: str, rt) -> dict:
    """Phase 9c: ``export`` of phase 6's trained fusion run in f32 and
    ``engine`` against ``infer`` (TF32 off, <= 1e-5), with a batch size
    that leaves a ragged tail; K2 4 and K3f 5 launches a batch, no K1."""
    saved = {k: rt.config.get_path(k) for k in ("train.compute_dtype", "data_loader.batch_size",
                                                 "data_loader.drop_last")}
    n = len(rt.datasets.get("infer") or rt.datasets["train"])
    batch_size = next(b for b in range(min(32, n - 1), 0, -1) if n % b)
    for k, v in (("train.compute_dtype", "float32"), ("data_loader.batch_size", batch_size),
                 ("data_loader.drop_last", False)):
        rt.set_config(k, v)
    t0 = time.perf_counter()
    export_dir = rt.export()
    seconds = time.perf_counter() - t0
    meta = json.loads((export_dir / "export_meta.json").read_text())
    ops = _program_ops(export_dir / "model.pt2")
    with no_tf32():
        counters = zero_counters()
        got = rt.engine(export_dir)
        launches = _kernel_launches(counters)
        want = rt.infer()
    for k, v in saved.items():
        rt.set_config(k, v)
    calls = -(-n // batch_size)
    err = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    log(f"export of the workflow's fusion run (f32): {seconds:.1f} s, {meta}, custom-op nodes "
        f"{ops}; engine vs infer over {n} samples in batches of {batch_size} (tail {n % batch_size}): "
        f"max|dlogit| {err:.3g} (<= 1e-5 required); launches {launches} [{card}]")
    per_call = _program_kernels(rt.config, serving=False)
    if not meta["symbolic_batch"] or not err <= 1e-5 or ops != per_call:
        raise SystemExit("export/engine of the fusion run failed its checks")
    if rt.device.type == "cuda":
        _require_program_launches(launches, calls, per_call, "engine")
    return {"launches": launches, "err": err, "export_s": seconds}


def main() -> int:
    import torch

    import tempfile

    card = device_and_build()
    records, ladder_launches = check_kernels()
    serving = check_serving(card=card)
    model, model32 = serving.pop("model"), serving.pop("model32")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        for d in ("raw", "workflow", "deploy"):
            (tmp / d).mkdir()
        raw = check_raw_serving(model, model32, card, tmp / "raw")
        workdir = REPO / "build" / "chip_smoke_train"
        shutil.rmtree(workdir, ignore_errors=True)
        try:
            training = check_training(card, workdir)
            check_training_parity(workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        workflow = check_workflow(card, tmp / "workflow")
        photometry = check_photometry(card)
        single = check_single_families(card)
        t0 = time.perf_counter()
        check_native_decoder(card, model, model32, raw)
        deployed = check_export_serving(card, model, model32, raw, tmp / "deploy")
        engine = check_export_engine(card, workflow["runtime"])
        log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    for r in records:
        by_path = {"serving": serving["launches"][r["name"]],
                   "raw_serving": raw["launches"][r["name"]],
                   "training": training["launches"][r["name"]],
                   "ladder": ladder_launches[r["name"]],
                   "workflow_train": workflow["train_launches"][r["name"]],
                   "workflow_serve": workflow["serve_launches"][r["name"]],
                   "photometry_steps": photometry["staged_launches"][r["name"]],
                   "photometry_protocol": photometry["protocol_launches"][r["name"]],
                   "single_steps": single["staged_launches"][r["name"]],
                   "single_protocol": single["protocol_launches"][r["name"]],
                   "export_serving": deployed["launches"][r["name"]],
                   "engine": engine["launches"][r["name"]]}
        path = ("ladder" if r["name"].startswith(LADDER_PREFIX) else
                "training" if r["name"] in TRAINING_KERNELS else "serving")
        r["launches"] = by_path[path]
        r["launches_by_path"] = by_path
    log(json.dumps({"kernels": records}))
    log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
