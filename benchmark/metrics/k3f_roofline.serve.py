"""Kernel K3f's share of its roofline, in %: SpectraNet's LayerNorm + GELU
forward (``ops/ln_gelu.py``, ``csrc/ln_gelu.cu``) over N rows of C reads x
once, writes y once and reads the scale and bias, about 20 operations an
element, at the peak of x's type."""

from benchmark.harness.readers import bound_s, dtype_name, roofline

SPANS = [("k3f", "module:applecider_tpu_torch.ops.ln_gelu", "ln_gelu_forward")]


def note(args, kwargs, out):
    x = args[0]
    C = x.shape[-1]
    return {"N": x.numel() // max(C, 1), "C": C, "size": x.element_size(),
            "dtype": dtype_name(x.dtype)}


def bound(n):
    nbytes = 2 * n["N"] * n["C"] * n["size"] + 2 * n["C"] * 4
    return bound_s(nbytes, 20.0 * n["N"] * n["C"], n["dtype"])


def read(reading):
    return roofline(reading, "k3f", bound)
