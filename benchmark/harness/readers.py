"""What the per-layer readers share: the card's published peaks, the
roofline bound of a call, and the reductions of a span's calls.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit):
989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor cores,
3.35 TB/s of HBM bandwidth.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def dtype_name(dtype) -> str:
    return str(dtype).rpartition(".")[2]


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the dtype's peak, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def timed(reading, span: str, key: str = "device_s") -> list[dict]:
    """The span's calls that have ``key``; none for a device time where the
    trace saw no device activity at all (a run without a card)."""
    if key == "device_s" and not reading.trace.get("busy_s"):
        return []
    return [c for c in reading.calls.get(span, []) if key in c]


def ms_per_call(reading, span: str, key: str = "device_s"):
    """Mean milliseconds of ``key`` over the span's calls; None without one."""
    calls = timed(reading, span, key)
    if not calls:
        return None
    return 1e3 * sum(c[key] for c in calls) / len(calls)


def roofline(reading, span: str, bound) -> float | None:
    """The span's summed bound (``bound(note)`` seconds a call) over the
    device time of every kernel its calls launched, in %."""
    calls = timed(reading, span)
    device = sum(c["device_s"] for c in calls)
    if not calls or device <= 0.0:
        return None
    return 100.0 * sum(bound(c["note"]) for c in calls) / device


def mfu(reading) -> float | None:
    """Model FLOPs of the work completed over the window and the bf16 peak,
    in %."""
    w = reading.window
    if not w["work"]["flops"] or w["window_s"] <= 0.0:
        return None
    return 100.0 * w["work"]["flops"] / w["window_s"] / PEAK_FLOPS["bfloat16"]


def idle_share(reading) -> float | None:
    """The share of the traced window in which no kernel, copy or fill ran
    on the card, in %."""
    t = reading.trace
    if not t.get("window_s") or t.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
