"""Kernel K1's share of its roofline, in %: the group starts of the 12-hour
merge (``ops/merge_scan.py``, ``csrc/merge_scan.cu``) over (B, P) light
curves read t (f32), band (int32) and valid (bool) once and write the ids
(int32) once; no floating-point operation bounds it."""

from benchmark.harness.readers import bound_s, roofline

SPANS = [("k1", "module:applecider_tpu_torch.infer.stream", "seg_ids")]


def note(args, kwargs, out):
    B, P = args[0].shape
    return {"B": B, "P": P}


def bound(n):
    return bound_s(n["B"] * n["P"] * (4 + 4 + 1 + 4), 0.0, "float32")


def read(reading):
    return roofline(reading, "k1", bound)
