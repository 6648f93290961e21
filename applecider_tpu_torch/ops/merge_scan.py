"""K1: the merge's greedy per-band group-start scan, batched.

Counterpart of ``applecider_tpu/ops/merge_scan.py``. ``seg_ids`` calls the
custom op ``applecider_torch::seg_ids``, which launches the hand-written
kernel ``csrc/merge_scan.cu`` on a CUDA tensor and runs the plain PyTorch
version ``seg_ids_reference`` on a CPU tensor; any other device raises. As
a custom op it stays one node of a ``torch.export`` graph. Both return, for
every slot, the position of the start of its band's open group, or P for
invalid slots and bands outside [0, 3).

The kernel gives a block to each light curve and a thread to each step.
Where each band's valid times are non-decreasing, with no NaN and no -inf
(the serving layout: time-ascending prefixes, +inf in the invalid tail),
it finds the group starts in O(log P) steps: each point's successor by a
search in its band's times, the chain from each band's first point by
pointer doubling, and each point's start as the last mark at or before it.
Every other row, and every row longer than 1024 steps, one warp walks with
the recurrence itself, on the card, and adds one to the device counter
``walked_rows(device)``, which a caller zeroes and reads to see which path
its rows took.
"""

from __future__ import annotations

import ctypes

import torch

from applecider_tpu_torch.ops.kernel import CudaKernel, require_cpu_or_cuda, require_cuda

N_BANDS = 3

KERNEL = CudaKernel(
    "merge_scan", "ac_seg_ids",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_float],
)
_walked: dict[torch.device, torch.Tensor] = {}


def walked_rows(device: torch.device) -> torch.Tensor:
    """The (1,) int32 counter on ``device`` to which K1 adds each row that it
    walked with the recurrence instead of the parallel path."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _walked:
        _walked[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return _walked[device]


def seg_ids_reference(t_sorted: torch.Tensor, band: torch.Tensor, valid: torch.Tensor,
                      dt_days: float = 0.5) -> torch.Tensor:
    """Plain PyTorch version: the recurrence as a loop over P, batched over B.

    t_sorted (B, P) f32, time-ascending with +inf at invalid slots;
    band (B, P) int; valid (B, P) bool. Returns (B, P) int32.
    """
    B, P = t_sorted.shape
    dev = t_sorted.device
    bands = torch.arange(N_BANDS, device=dev, dtype=band.dtype)
    dt = torch.tensor(dt_days, dtype=torch.float32, device=dev)
    t0 = torch.full((B, N_BANDS), -float("inf"), dtype=torch.float32, device=dev)
    start = torch.zeros((B, N_BANDS), dtype=torch.int32, device=dev)
    out = torch.empty((B, P), dtype=torch.int32, device=dev)
    for i in range(P):
        ti = t_sorted[:, i, None]
        is_b = (band[:, i, None] == bands) & valid[:, i, None]
        new = is_b & (ti > t0 + dt)
        t0 = torch.where(new, ti, t0)
        start = torch.where(new, torch.full_like(start, i), start)
        seg = torch.where(is_b, start, 0).sum(dim=1, dtype=torch.int32)
        out[:, i] = torch.where(is_b.any(dim=1), seg, P)
    return out


def seg_ids(t_sorted: torch.Tensor, band: torch.Tensor, valid: torch.Tensor,
            dt_days: float = 0.5) -> torch.Tensor:
    """Batched group-start ids; kernel K1 on CUDA, the plain version on CPU."""
    require_cpu_or_cuda(t_sorted, band, valid)
    return seg_ids_op(t_sorted, band, valid, float(dt_days))


@torch.library.custom_op("applecider_torch::seg_ids", mutates_args=(), device_types="cuda")
def seg_ids_op(t_sorted: torch.Tensor, band: torch.Tensor, valid: torch.Tensor,
               dt_days: float) -> torch.Tensor:
    """K1 on CUDA tensors (the CPU's implementation is ``seg_ids_reference``)."""
    dev = require_cuda(t_sorted, band, valid)
    if t_sorted.dim() != 2 or band.shape != t_sorted.shape or valid.shape != t_sorted.shape:
        raise ValueError(f"seg_ids takes three (B, P) tensors, got {t_sorted.shape}, "
                         f"{band.shape}, {valid.shape}")
    if t_sorted.dtype != torch.float32 or band.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError("seg_ids takes t float32, band int32, valid bool")
    if not (t_sorted.is_contiguous() and band.is_contiguous() and valid.is_contiguous()):
        raise ValueError("seg_ids takes contiguous tensors")
    B, P = t_sorted.shape
    out = torch.empty((B, P), dtype=torch.int32, device=dev)
    KERNEL.launch(dev, t_sorted, band, valid, out, walked_rows(dev), B, P, float(dt_days))
    return out


seg_ids_op.register_kernel("cpu")(seg_ids_reference)


@seg_ids_op.register_fake
def _(t_sorted, band, valid, dt_days):
    return t_sorted.new_empty(t_sorted.shape, dtype=torch.int32)
