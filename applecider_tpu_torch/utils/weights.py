"""Carry the JAX package's flax parameters over to the port.

The port names its submodules after the flax modules, so the mapping is
mechanical: the nested flax dict (NumPy leaves) flattens to dotted names,
and each leaf changes layout by its kind:

* Linear ``kernel`` (in, out) -> ``weight`` (out, in);
* conv1d ``kernel`` (K, Cin, Cout) -> ``weight`` (Cout, Cin, K);
* conv2d ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm and BatchNorm ``scale`` -> ``weight``;
* everything else (``bias``, ``cls_tok``, ``gamma``, Time2Vec's ``w0``,
  ``b0``, ``w``, ``b``; the zoo's ``cls``, ``pos``, and its raw conv1d
  leaves ``token_kernel`` and ``conv{i}_kernel``, which the port keeps in
  the flax layout (K, Cin, Cout); ``experimental``'s ``pe`` and ``b``) as
  it is.

TriPool's ``head_fc1`` kernel (C * L, 2048) is laid out channel-major,
because both packages flatten the last stage's (B, L, C) activations as
(B, C, L); it transposes like any Linear. Its frozen BatchNorm, and
SpectraEfficientNetV2's, keep ``scale`` and ``bias`` in flax ``params``
(mapped as above) and the running statistics in the ``batch_stats``
collection: ``mean`` becomes the buffer ``running_mean`` and ``var``
``running_var``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


_STATS = {"mean": "running_mean", "var": "running_var"}


def from_jax_params(params: Mapping, batch_stats: Mapping | None = None
                    ) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from flax ``params`` and, for a
    model with frozen BatchNorm, its ``batch_stats``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: tuple[str, ...], stats: bool = False) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, (*prefix, key), stats)
                continue
            arr = np.asarray(value, np.float32)
            name = key
            if stats:
                name = _STATS[key]
            elif key == "kernel":
                arr = arr.transpose(_KERNEL_AXES[arr.ndim])
                name = "weight"
            elif key == "scale":
                name = "weight"
            out[".".join((*prefix, name))] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, ())
    walk(batch_stats or {}, (), stats=True)
    return out
