"""Time K4x, the forward ablation ladder of K4, on the card.

    python3 -m applecider_tpu_torch.tools.flash_microab

Counterpart of the timing half of ``scripts/tpu_flash_microab.py``. Times
every rung of ``ops/flash_microab.py`` at the training shape of the
photometry attention (B = 256, H = 8, L = 258, hd = 16, bf16, dropout rate
0.4) on inputs made from ``np.random.default_rng(0)`` (q, k, v normal, a
random key mask ``< 0.2``, as the script makes them). In bf16 every rung
is an instantiation of the tensor-core forward the training step runs
(``flash_fwd_mma_kernel``; ``batched{N}`` its N-heads-a-block form), and
each rung of the report names its kernel (``route``). Two interleaved
rounds of CUDA-event times over 30 launches each; the minimum per rung is
kept. Beside each rung: its bound (q, k, v and out read or written once
plus the mask, at the card's memory rate, or the two products at its peak
rate, whichever is larger) and, where one PyTorch call computes the same
function, that call's time: ``scaled_dot_product_attention`` with the mask,
``dropout_p = 0.4`` for ``full`` and 0 for the rungs whose output is
``no_prng``'s (``prng_only_no_apply`` and ``batched*`` too).
Then the split of ``full``'s time: softmax (``no_prng - matmul_only``),
draw (``prng_only_no_apply - no_prng``: the Philox counters, the fill of
the tile's keep bytes and the shared memory they take), apply (``full -
prng_only_no_apply``: the keep bit's select and the scale) and pairing
(``batched{N} - no_prng``).

Needs a GPU; prints the card's name and power limit first and the report
as one JSON line last. Writes nothing to disk.
"""

from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from applecider_tpu_torch.device import card_name_and_power, resolve_device
from applecider_tpu_torch.ops.flash_microab import MODES, flash_forward_ablation, route

TRAIN_SHAPE = (256, 8, 258, 16)
RATE, SEED = 0.4, 7
ROUNDS, ITERS = 2, 30
# peak rates of one H100 SXM (NVIDIA data sheet, dense): bytes/s and ops/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
LADDER = ("full", "prng_only_no_apply", "no_prng", "matmul_only")
# the dropout_p of the SDPA call that computes each rung's function;
# matmul_only has none
LIBRARY_RATE = {"full": RATE, "no_prng": 0.0, "prng_only_no_apply": 0.0, "batched4": 0.0,
                "batched8": 0.0}


def make_inputs(dtype=torch.bfloat16, device="cuda"):
    """The ladder's q, k, v (B, H, L, hd) at the train shape and the (B, L)
    key mask, True = padded."""
    B, H, L, hd = TRAIN_SHAPE
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=TRAIN_SHAPE).astype(np.float32)).to(device, dtype)
               for _ in range(3))
    mask = torch.from_numpy(rng.random((B, L)) < 0.2).to(device)
    return q, k, v, mask


def bound_ms(shape, dtype) -> tuple[float, str]:
    """The least time for one rung: q, k, v and out once plus the mask at
    the memory rate, or the two products at the dtype's peak rate."""
    B, H, L, hd = shape
    nbytes = 4 * B * H * L * hd * torch.empty((), dtype=dtype).element_size() + B * L
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * B * H * L * L * hd / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split(ms: dict) -> dict:
    """Each stage's cost in ms and as a share of ``full``, from the rungs'
    times; pairing is negative where the batched kernel is faster."""
    stages = {
        "products": ms["matmul_only"],
        "softmax": ms["no_prng"] - ms["matmul_only"],
        "draw": ms["prng_only_no_apply"] - ms["no_prng"],
        "apply": ms["full"] - ms["prng_only_no_apply"],
    }
    stages.update({f"pairing_{m}": ms[m] - ms["no_prng"] for m in ms if m.startswith("batched")})
    return {name: {"ms": t, "share_of_full": t / ms["full"]} for name, t in stages.items()}


def _event_ms(fn, iters: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ladder(device="cuda") -> dict:
    """Time every rung and its library call on ``device``, at the train
    shape in bf16; the report."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the ladder times the card; got {dev}")
    q, k, v, mask = make_inputs(device=dev)
    attend = ~mask[:, None, None, :]
    rungs = {m: (lambda m=m: flash_forward_ablation(q, k, v, mask, m, RATE, SEED)) for m in MODES}
    library = {p: (lambda p=p: F.scaled_dot_product_attention(q, k, v, attn_mask=attend, dropout_p=p))
               for p in set(LIBRARY_RATE.values())}
    for fn in (*rungs.values(), *library.values()):  # first launches, library plans
        fn()
    torch.cuda.synchronize()
    ms, lib_ms = {}, {}
    for _ in range(ROUNDS):
        for m, fn in rungs.items():
            ms[m] = min(ms.get(m, float("inf")), _event_ms(fn, ITERS))
        for p, fn in library.items():
            lib_ms[p] = min(lib_ms.get(p, float("inf")), _event_ms(fn, ITERS))
    b_ms, b_by = bound_ms(TRAIN_SHAPE, torch.bfloat16)
    B, H, L, hd = TRAIN_SHAPE
    return {
        "shape": {"B": B, "H": H, "L": L, "hd": hd}, "dtype": "bfloat16",
        "rate": RATE, "rounds": ROUNDS, "iters": ITERS,
        "rungs": {m: {"route": route(m, torch.bfloat16), "ms": ms[m], "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms[LIBRARY_RATE[m]] if m in LIBRARY_RATE else None}
                  for m in MODES},
        "stages": split(ms),
    }


def main() -> None:
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    report = ladder()
    full = report["rungs"]["full"]["ms"]
    prev = None
    for m in (*LADDER, "batched4", "batched8"):
        r = report["rungs"][m]
        step = "" if prev is None or m.startswith("batched") else f", {r['ms'] - prev:+.4f} from the rung above"
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"{m:>20}: {r['ms']:.4f} ms ({r['ms'] / full:.1%} of full{step}); bound "
              f"{r['bound_ms']:.5f} ms ({r['bound_by']}); sdpa {lib}; {r['route']}", flush=True)
        if m in LADDER:
            prev = r["ms"]
    for name, s in report["stages"].items():
        print(f"{name:>20}: {s['ms']:+.4f} ms, {s['share_of_full']:+.1%} of full", flush=True)
    print(json.dumps({"card": card, **report}))


if __name__ == "__main__":
    main()
