"""Kernel K2's share of its roofline, in %: the serving attention
(``ops/attention.py``, ``csrc/attention.cu``) over (B, H, L, hd) reads q, k,
v and the (B, L) mask once and writes the output once, and does 4 B H L^2 hd
operations (two products), at the bf16 or f32 peak of q's type."""

from benchmark.harness.readers import bound_s, dtype_name, roofline

SPANS = [("k2", "module:applecider_tpu_torch.models.layers", "masked_attention")]


def note(args, kwargs, out):
    B, H, L, hd = args[0].shape
    return {"B": B, "H": H, "L": L, "hd": hd, "size": args[0].element_size(),
            "dtype": dtype_name(args[0].dtype)}


def bound(n):
    nbytes = 4 * n["B"] * n["H"] * n["L"] * n["hd"] * n["size"] + n["B"] * n["L"]
    return bound_s(nbytes, 4.0 * n["B"] * n["H"] * n["L"] ** 2 * n["hd"], n["dtype"])


def read(reading):
    return roofline(reading, "k2", bound)
