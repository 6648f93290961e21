"""SpectraNet's and TriPool's bank convolutions on the card by each route,
the CUDA constants of ``ops/conv1d.py``'s router, and TriPool's bf16 step.

    python3 -m applecider_tpu_torch.tools.conv_routes

For every bank convolution of SpectraNet at serving (B = 512) and at
training (B = 256), stage 0 in bf16 and stages 1-4 in f32 (a bf16 model's
downsample bias promotes them), and of TriPool at training (B = 32, bf16 in
every stage), at the published widths on the 3,481-bin grid:

1. FFT and space-to-depth against direct on the same inputs in f32 (TF32
   off), four rows, at ``tests/test_spectranet.py``'s FFT tolerances (5e-4
   for K >= 512, else 2e-4);
2. the time of each route (the median of repeated launches, CUDA events):
   the forward, and at training the forward and backward (the input's
   gradient from stage 1 on, the weight's and the bias's); in bf16 also the
   direct route with cuDNN's bf16 input gradient
   (``ops.conv1d.BF16_INPUT_GRAD_IN_F32 = False``), the route this port
   replaced. Space-to-depth is skipped where its R-fold weight would pass
   ``S2D_MAX_ELEMENTS``;
3. the route ``auto`` takes at each shape with the committed constants, and
   the FFT penalty that this run's table would pick: the one that loses
   the least time to misroutes, FFT against direct, over the shapes with K
   of at least ``FFT_KERNEL_THRESHOLD`` (training shapes by their forward
   and backward, serving shapes by their forward);
4. TriPool's training step at B = 32 (``configs/spectra.toml``) with
   ``conv_mode = "direct"`` in bf16 with the port's input gradient and with
   cuDNN's, with ``"auto"`` in bf16, and direct in f32 (TF32 on, as the
   runtime runs): step ms by phase and the device time in cuDNN's bf16
   ``dgrad_engine`` kernels under ``torch.profiler``.

``run(card)`` returns the report (``chip_smoke.py`` phase 14); ``main``
prints it, the card's name and power limit first and one JSON line last.
"""

from __future__ import annotations

import json
import math
import shutil
import time

import torch

from applecider_tpu_torch.ops import conv1d as C
from applecider_tpu_torch.tools.kernel_timing import time_ms

SPECTRUM_BINS = 3481
SPECTRANET_CHANNELS = (64, 128, 256, 512, 1024)
TRIPOOL_CHANNELS = (16, 32, 64, 128, 256)
BANKS = ((3, 61, 1021), (3, 31, 251), (3, 15, 61), (3, 11, 31), (3, 7, 13))
# (what, batch, tripool, training)
SETS = (("SpectraNet serving", 512, False, False), ("SpectraNet training", 256, False, True),
        ("TriPool training", 32, True, True))
S2D_MAX_ELEMENTS = 1 << 29  # 2 GiB of f32 weight (SpectraNet's stage 4: 6.4 GiB)
DGRAD_BF16 = "dgrad_engine<__nv_bfloat16"


def bank_shapes(channels, banks, length: int, tripool: bool) -> list[tuple]:
    """(stage, L, cin, cout, K) of every bank convolution, depth 1 a stage:
    SpectraNet's downsample gives the next stage ``channels[s]`` channels,
    TriPool's tri-pool 3 x (convs x ``channels[s]``)."""
    out, cin, L = [], 1, length
    for s, (cout, ks) in enumerate(zip(channels, banks)):
        out += [(s, L, cin, cout, k) for k in ks]
        cin = cout * len(ks) * 3 if tripool else cout
        L //= 4
    return out


def s2d_elements(cin: int, cout: int, k: int, R: int = 32) -> int:
    """Elements of ``conv1d_s2d``'s (D, R*cin, R*cout) weight."""
    P0 = k // 2
    D = (k - 1 + R - 1 - P0) // R + (P0 + R - 1) // R + 1
    return D * R * cin * R * cout


def fft_cost_ratio(B: int, L: int, k: int, cin: int, cout: int) -> float:
    """direct FLOPs over the FFT route's modelled cost without its penalty:
    ``_fft_wins`` takes FFT where the penalty is below this."""
    direct, fft = C.fft_costs(L, k, cin, cout, B)
    return direct / fft


def _inputs(gen, B, L, cin, cout, k, dtype, dev):
    bound = 1.0 / math.sqrt(cin * k)
    x = torch.randn(B, L, cin, generator=gen, device=dev).to(dtype)
    w = (torch.rand(cout, cin, k, generator=gen, device=dev) * 2 - 1) * bound
    b = (torch.rand(cout, generator=gen, device=dev) * 2 - 1) * bound
    return x, w, b


ROUTES = {"direct": C.conv1d_direct, "fft": C.conv1d_fft, "s2d": C.conv1d_s2d}


def check_routes(shapes: list, dev, rows: int = 4) -> list[dict]:
    """FFT and space-to-depth against direct in f32, TF32 off, per shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        with torch.no_grad():
            for L, cin, cout, k in shapes:
                x, w, b = _inputs(gen, rows, L, cin, cout, k, torch.float32, dev)
                want = C.conv1d_direct(x, w, b)
                tol = 5e-4 if k >= 512 else 2e-4
                row = {"L": L, "cin": cin, "cout": cout, "K": k, "tol": tol}
                for name in ("fft", "s2d"):
                    if name == "s2d" and s2d_elements(cin, cout, k) > S2D_MAX_ELEMENTS:
                        continue
                    row[name] = float((ROUTES[name](x, w, b) - want).abs().max())
                row["ok"] = all(row.get(n, 0.0) <= tol for n in ("fft", "s2d"))
                out.append(row)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def time_shape(gen, B, L, cin, cout, k, dtype, training: bool, dev, iters: int = 3,
               reps: int = 3) -> dict:
    """ms of each route's forward (and forward + backward at training)."""
    x, w, b = _inputs(gen, B, L, cin, cout, k, dtype, dev)
    row = {}
    names = ["direct", "fft"] + (["s2d"] if s2d_elements(cin, cout, k) <= S2D_MAX_ELEMENTS
                                 else [])
    for name in names:
        f = ROUTES[name]
        with torch.no_grad():
            row[f"{name}_fwd"] = time_ms(lambda: f(x, w, b), iters=iters, reps=reps)
    if training:
        xg = x.clone().requires_grad_(L != SPECTRUM_BINS)  # the spectrum takes no gradient
        wg, bg = w.clone().requires_grad_(), b.clone().requires_grad_()
        gy = torch.randn(B, L, cout, generator=gen, device=dev)

        def step(f):
            xg.grad = wg.grad = bg.grad = None
            f(xg, wg, bg).backward(gy)

        for name in names:
            row[f"{name}_fwd_bwd"] = time_ms(lambda: step(ROUTES[name]), iters=iters, reps=reps)
        if dtype == torch.bfloat16:
            C.BF16_INPUT_GRAD_IN_F32 = False
            try:
                row["direct_cudnn_dgrad_fwd_bwd"] = time_ms(lambda: step(C.conv1d_direct),
                                                            iters=iters, reps=reps)
            finally:
                C.BF16_INPUT_GRAD_IN_F32 = True
    return row


def route_table(dev) -> list[dict]:
    """Every bank shape of ``SETS`` timed by each route, with ``auto``'s route."""
    gen = torch.Generator(device=dev).manual_seed(1)
    table = []
    for what, B, tripool, training in SETS:
        channels = TRIPOOL_CHANNELS if tripool else SPECTRANET_CHANNELS
        for s, L, cin, cout, k in bank_shapes(channels, BANKS, SPECTRUM_BINS, tripool):
            dtype = torch.bfloat16 if (tripool or s == 0) else torch.float32
            row = {"set": what, "stage": s, "B": B, "L": L, "cin": cin, "cout": cout, "K": k,
                   "dtype": str(dtype).replace("torch.", ""), "training": training,
                   **time_shape(gen, B, L, cin, cout, k, dtype, training, dev)}
            key = "_fwd_bwd" if training else "_fwd"
            timed = {n: row[n + key] for n in ROUTES if n + key in row}
            row["best"] = min(timed, key=timed.get)
            row["auto"] = C.route(B, L, k, cin, cout, "auto", "cuda")
            row["auto_loss_ms"] = timed[row["auto"]] - timed[row["best"]]
            row["ratio"] = fft_cost_ratio(B, L, k, cin, cout)
            table.append(row)
    return table


def calibrate_penalty(table: list) -> dict:
    """The FFT penalty that loses the least time to misroutes between FFT and
    direct over the shapes the cost model decides (K >= the threshold; ties
    go to the larger penalty, towards direct)."""
    rows = [r for r in table if r["K"] >= C.FFT_KERNEL_THRESHOLD]
    key = {id(r): ("_fwd_bwd" if r["training"] else "_fwd") for r in rows}
    cands = sorted({0.0} | {r["ratio"] * f for r in rows for f in (0.999, 1.001)}
                   | {max(r["ratio"] for r in rows) * 2})

    def loss(p):
        lost, wrong = 0.0, 0
        for r in rows:
            pick = "fft" if p < r["ratio"] else "direct"
            other = "direct" if pick == "fft" else "fft"
            d = r[pick + key[id(r)]] - r[other + key[id(r)]]
            lost += max(d, 0.0)
            wrong += d > 0
        return lost, wrong

    best = min(cands, key=lambda p: (loss(p)[0], -p))
    lost, wrong = loss(best)
    now_lost, now_wrong = loss(C._PENALTY["cuda"])
    return {"penalty": best, "lost_ms": lost, "misroutes": wrong, "shapes": len(rows),
            "committed": C._PENALTY["cuda"], "committed_lost_ms": now_lost,
            "committed_misroutes": now_wrong,
            "s2d_wins": [f"{r['set']} stage {r['stage']} K={r['K']}" for r in table
                         if r["K"] >= 512 and r["cin"] <= 2 and r["best"] == "s2d"]}


def module_routes(module, batch: int, length: int, platform: str = "cuda") -> list[str]:
    """The route of each bank conv of a SpectraNet or TriPool module at
    ``batch`` spectra of ``length`` bins (``ops.conv1d.route``)."""
    out, L = [], length
    for name in module.block_names:
        block = getattr(module, name)
        convs = [getattr(block, f"conv_{i}") for i in range(block.n_convs)]
        for c in convs:
            cout, cin, k = c.weight.shape
            out.append(f"{name} K={k} cin={cin} L={L}: "
                       f"{C.route(batch, L, k, cin, cout, block.conv_mode, platform)}")
        L = L // 4 if block.do_pool else L
    return out


# TriPool's step variants: (conv_mode, dtype, the f32 input gradient in bf16)
STEP_VARIANTS = {"direct_bf16": ("direct", "bfloat16", True),
                 "direct_bf16_cudnn_dgrad": ("direct", "bfloat16", False),
                 "auto_bf16": ("auto", "bfloat16", True),
                 "direct_f32": ("direct", "float32", True)}


def tripool_steps() -> dict:
    """TriPool's B = 32 training step under ``conv_mode = "direct"`` in bf16
    with the port's input gradient and with cuDNN's, under ``"auto"`` in
    bf16, and direct in f32 (TF32 on)."""
    from applecider_tpu_torch.models.spectranet import SpectraNetTriPoolTask
    from applecider_tpu_torch.tools.profile_tasks import WORKDIR, profile_task

    out = {}
    for tag, (mode, dtype, f32_dgrad) in STEP_VARIANTS.items():
        C.BF16_INPUT_GRAD_IN_F32 = f32_dgrad
        try:
            r = profile_task("SpectraNetTriPool", SpectraNetTriPoolTask, "spectra", dtype, top=40,
                             overrides={"model": {"SpectraNetTriPool": {"conv_mode": mode}}})
        finally:
            C.BF16_INPUT_GRAD_IN_F32 = True
        prof = r["profile"]
        dgrad = sum(row["ms"] for row in prof["top"] if DGRAD_BF16 in row["kernel"])
        out[tag] = {"batch": r["batch"], "phases": r["phases"], "routes": r["routes"],
                    "device_busy_ms": prof["device_busy_ms"], "steps": prof["steps"],
                    "dgrad_bf16_ms": dgrad,
                    "dgrad_bf16_share": dgrad / prof["device_busy_ms"] if prof["device_busy_ms"]
                    else None, "top": prof["top"][:6]}
        torch.cuda.empty_cache()
    shutil.rmtree(WORKDIR, ignore_errors=True)
    return out


def run(card: str, log=print) -> dict:
    """The checks, the route table and TriPool's steps; logs each line."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    shapes = sorted({(L, cin, cout, k) for _, _, tripool, _ in SETS
                     for _, L, cin, cout, k in bank_shapes(
                         TRIPOOL_CHANNELS if tripool else SPECTRANET_CHANNELS, BANKS,
                         SPECTRUM_BINS, tripool)})
    checks = check_routes(shapes, dev)
    for c in checks:
        s2d = (f"max|s2d - direct| {c['s2d']:.3g}" if "s2d" in c
               else f"s2d not run (its weight passes {S2D_MAX_ELEMENTS} elements)")
        log(f"  L={c['L']} cin={c['cin']} cout={c['cout']} K={c['K']}: max|fft - direct| "
            f"{c['fft']:.3g}, {s2d} (<= {c['tol']:g})")
    log(f"conv routes checked against direct, f32, TF32 off, 4 rows: {len(checks)} shapes, "
        f"{sum(c['ok'] for c in checks)} within tolerance [{card}]")
    table = route_table(dev)
    log("conv route table (ms; fwd = forward, fb = forward + backward; auto = the route "
        f"ops.conv1d takes with the committed constants) [{card}]")
    for r in table:
        cells = " ".join(f"{k.replace('_fwd_bwd', ' fb').replace('_fwd', ' fwd')}={v:.4f}"
                         for k, v in r.items() if k.endswith(("_fwd", "_fwd_bwd")))
        log(f"  {r['set']} s{r['stage']} B={r['B']} L={r['L']} cin={r['cin']} cout={r['cout']} "
            f"K={r['K']} {r['dtype']}: {cells}; best {r['best']}, auto {r['auto']} "
            f"(+{r['auto_loss_ms']:.4f} ms), cost ratio {r['ratio']:.3g}")
    cal = calibrate_penalty(table)
    log(f"FFT penalty this table picks: {cal['penalty']:.4g} ({cal['misroutes']} of "
        f"{cal['shapes']} shapes misrouted, {cal['lost_ms']:.4f} ms lost); committed "
        f"{cal['committed']:.4g} ({cal['committed_misroutes']} misrouted, "
        f"{cal['committed_lost_ms']:.4f} ms lost); s2d fastest at {cal['s2d_wins']} [{card}]")
    steps = tripool_steps()
    for tag, s in steps.items():
        p = s["phases"]
        routes = sorted({r.rsplit(": ", 1)[1] for r in s["routes"]})
        log(f"TriPool step {tag} (routes {routes}), batch {s['batch']}: {p['step_ms']:.3f} ms (forward "
            f"{p['forward_ms']:.3f}, backward {p['backward_ms']:.3f}, clip + optimizer "
            f"{p['clip_adam_ms']:.3f}); {s['steps']} steps profiled: device busy "
            f"{s['device_busy_ms']:.2f} ms, in {DGRAD_BF16}...> {s['dgrad_bf16_ms']:.2f} ms "
            f"(share {s['dgrad_bf16_share']:.3f}) [{card}]")
        for row in s["top"]:
            log(f"    {row['ms']:9.3f} ms {row['calls']:5d}x {row['kernel']}")
    seconds = time.perf_counter() - t0
    log(f"conv routes took {seconds:.1f} s [{card}]")
    return {"checks": checks, "table": table, "calibration": cal, "tripool": steps,
            "seconds": seconds}


def main() -> None:
    from applecider_tpu_torch.device import card_name_and_power

    if not torch.cuda.is_available():
        raise SystemExit("conv_routes needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    report = run(card, log=lambda m: print(m, flush=True))
    print(card, flush=True)
    print(json.dumps({"card": card, **report}), flush=True)


if __name__ == "__main__":
    main()
