"""The host's share of eager serving on the card: each serving kernel's
wrapper call, and the serving rate it feeds.

    python3 -m applecider_tpu_torch.tools.host_overhead

1. For K1 (B = 512, P = 257 serving rows), K2 (B = 512, 8 heads, L = 256,
   hd 16, bf16) and K3f (N = 337,657, C = 192, f32), each through its
   wrapper (``ops.merge_scan.seg_ids``, ``ops.attention.masked_attention``,
   ``ops.ln_gelu.ln_gelu_forward``): ``host_us``, the host's time to issue
   one call while the card is held busy (so the enqueue alone), beside
   ``ms`` (CUDA events around a run of calls, which hold the host's gaps)
   and ``device_ms`` (the calls queued behind a sleep: the device alone);
2. the serving path of ``chip_smoke.py`` phase 3 in bf16 at the published
   widths: 2,048 synthetic alerts through ``LengthBinnedFeeder(
   FusedSpectraStream(model), flush_bs=512)``, a warm-up pass, then
   ``passes`` timed passes (alerts/s each).

Needs a GPU; prints the card's name and power limit first and one JSON line
last. Run by path with another checkout's root on ``PYTHONPATH``
(``PYTHONPATH=<root> python3 <this file>``), it measures that checkout's
package with this script: run two packages in turns in one call for an A/B.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N_CALLS = 200  # calls issued while the card sleeps


def wrapper_costs(dev) -> dict:
    """``host_us``, ``ms`` and ``device_ms`` of K1, K2 and K3f's wrappers."""
    from applecider_tpu_torch.ops import attention, ln_gelu, merge_scan
    from applecider_tpu_torch.tools.kernel_timing import serving_rows, time_ms

    g = torch.Generator(device=dev).manual_seed(0)
    t, band, valid = serving_rows(np.random.default_rng(0), 512, 257, dev)
    q = torch.randn(512, 8, 256, 16, device=dev, dtype=torch.bfloat16, generator=g)
    mask = torch.rand(512, 256, device=dev, generator=g) < 0.2
    x = torch.randn(337_657, 192, device=dev, generator=g)
    scale, bias = torch.rand(192, device=dev, generator=g), torch.rand(192, device=dev, generator=g)
    calls = {"K1": lambda: merge_scan.seg_ids(t, band, valid, 0.5),
             "K2": lambda: attention.masked_attention(q, q, q, mask),
             "K3f": lambda: ln_gelu.ln_gelu_forward(x, scale, bias)}
    out = {}
    for name, fn in calls.items():
        row = {"ms": time_ms(fn), "device_ms": time_ms(fn, queued=True)}
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)  # the card busy while the host issues the calls
        t0 = time.perf_counter()
        for _ in range(N_CALLS):
            fn()
        row["host_us"] = (time.perf_counter() - t0) / N_CALLS * 1e6
        torch.cuda.synchronize()
        out[name] = row
    return out


def serving_rates(dev, passes: int = 5, n_alerts: int = 2048) -> list[float]:
    """Alerts/s of ``passes`` passes of phase 3's serving workload."""
    from applecider_tpu_torch.infer.stream import FusedSpectraStream, LengthBinnedFeeder
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.testing import make_alert_samples

    model = build_fusion_model(device=dev, dtype=torch.bfloat16,
                               generator=torch.Generator().manual_seed(0))
    samples = make_alert_samples(n_alerts, seed=1, spectrum_frac=0.3, length_range=(20, 257),
                                 spectrum_points=(80, 2000))
    stream = FusedSpectraStream(model, device=dev)
    rates = []
    for i in range(passes + 1):
        feeder = LengthBinnedFeeder(stream, flush_bs=512, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, resolve in feeder.submit(list(enumerate(samples))) + feeder.flush():
            resolve()
        if i:  # pass 0 warms up: first launches, cuDNN plans
            rates.append(n_alerts / (time.perf_counter() - t0))
    return rates


def main() -> None:
    import applecider_tpu_torch
    from applecider_tpu_torch.device import card_name_and_power
    from applecider_tpu_torch.ops import kernel

    if not torch.cuda.is_available():
        raise SystemExit("host_overhead needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    kernel.build()
    dev = torch.device("cuda")
    report = {"card": card, "package": applecider_tpu_torch.__file__,
              "wrappers": wrapper_costs(dev), "serving_alerts_per_s": serving_rates(dev)}
    for name, row in report["wrappers"].items():
        print(f"{name} wrapper: " + " ".join(f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    print(f"serving alerts/s: {report['serving_alerts_per_s']}", flush=True)
    print(card, flush=True)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    sys.exit(main())
