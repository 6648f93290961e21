"""Device time of a kernel call on the card, and K1 timed at its serving shapes.

    python3 -m applecider_tpu_torch.tools.kernel_timing
    PYTHONPATH=<root of another checkout> python3 applecider_tpu_torch/tools/kernel_timing.py

``time_ms`` is how ``chip_smoke.py`` times every kernel. Run as a program,
the script times K1 (``ops.merge_scan.seg_ids``) on rows in the serving
layout at B = 1024, P = 257 and at B = 512 and each serving length, both
as every kernel is timed (``ms``) and with the calls queued behind a sleep
(``device_ms``: the device alone, without the host's enqueue of each
call), and the plain version at the first shape. Run by path with another
checkout's root on ``PYTHONPATH``, it times that checkout's K1 with this
script, for an A/B in one call. Needs a GPU; prints the card's name and
power limit first and one JSON line last.
"""

from __future__ import annotations

import json

import numpy as np
import torch

K1_SHAPES = ((1024, 257),) + tuple((512, P) for P in (63, 127, 191, 255, 257))


def time_ms(fn, iters: int = 10, reps: int = 5, queued: bool = False) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` calls.
    ``queued``: each rep first holds the card in a sleep (~50 ms) while the
    host queues the calls, so that the events time the device alone, and
    not a host that enqueues slower than the card runs a short kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if queued:
            torch.cuda._sleep(100_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def serving_rows(rng, B: int, P: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's inputs in the serving layout: each row time-ascending over 30
    days with +inf in the invalid tail, a random number of valid points and
    random bands; from B = 72 rows up, the first 8 rows empty, rows 8-39 on
    a quarter-day grid (duplicate times, gaps of exactly dt) and rows 40-71
    with bands in [-1, 5)."""
    t = np.sort(rng.uniform(0, 30, (B, P)), axis=1).astype(np.float32)
    n_valid = rng.integers(0, P + 1, B)
    special = B >= 72
    if special:
        n_valid[:8] = 0
        t[8:40] = np.round(t[8:40] * 4.0) / 4.0
    valid = np.arange(P)[None, :] < n_valid[:, None]
    t = np.where(valid, t, np.inf).astype(np.float32)
    band = rng.integers(0, 3, (B, P)).astype(np.int32)
    if special:
        band[40:72] = rng.integers(-1, 5, (32, P))
    return (torch.from_numpy(t).to(device), torch.from_numpy(band).to(device),
            torch.from_numpy(valid).to(device))


def time_k1(device, seed: int = 0, check=None) -> list[dict]:
    """K1 at each of ``K1_SHAPES``: ``ms`` and ``device_ms``; the first
    shape also the plain version's ``plain_ms``. ``check(t, band, valid)``,
    when given, is called on each shape's inputs before they are timed."""
    from applecider_tpu_torch.ops.merge_scan import seg_ids, seg_ids_reference

    rng = np.random.default_rng(seed)
    rows = []
    for n, (B, P) in enumerate(K1_SHAPES):
        t, band, valid = serving_rows(rng, B, P, device)
        if check is not None:
            check(t, band, valid)
        run = lambda: seg_ids(t, band, valid, 0.5)  # noqa: E731
        row = {"B": B, "P": P, "ms": time_ms(run), "device_ms": time_ms(run, queued=True)}
        if n == 0:
            row["plain_ms"] = time_ms(lambda: seg_ids_reference(t, band, valid, 0.5), iters=2, reps=3)
        rows.append(row)
    return rows


def main() -> None:
    from applecider_tpu_torch.device import card_name_and_power

    if not torch.cuda.is_available():
        raise SystemExit("kernel_timing needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    rows = time_k1(torch.device("cuda"))
    for r in rows:
        print("K1 " + " ".join(f"{k}={v}" for k, v in r.items()), flush=True)
    print(card, flush=True)
    print(json.dumps({"card": card, "k1": rows}), flush=True)


if __name__ == "__main__":
    main()
