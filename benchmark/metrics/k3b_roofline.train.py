"""Kernel K3b's share of its roofline, in %: SpectraNet's LayerNorm + GELU
backward (``ops/ln_gelu.py``, ``csrc/ln_gelu.cu``) over N rows of C reads x
and the output gradient once, writes the input gradient once and the scale's
and bias' gradients, about 40 operations an element, at the peak of x's
type."""

from benchmark.harness.readers import bound_s, dtype_name, roofline

SPANS = [("k3b", "module:applecider_tpu_torch.ops.ln_gelu", "ln_gelu_backward")]


def note(args, kwargs, out):
    x = args[0]
    C = x.shape[-1]
    return {"N": x.numel() // max(C, 1), "C": C, "size": x.element_size(),
            "dtype": dtype_name(x.dtype)}


def bound(n):
    nbytes = 3 * n["N"] * n["C"] * n["size"] + 4 * n["C"] * 4
    return bound_s(nbytes, 40.0 * n["N"] * n["C"], n["dtype"])


def read(reading):
    return roofline(reading, "k3b", bound)
