"""Carry the JAX package's flax parameters over to the port.

The port names its submodules after the flax modules, so the mapping is
mechanical: the nested flax dict (NumPy leaves) flattens to dotted names,
and each leaf changes layout by its kind:

* Linear ``kernel`` (in, out) -> ``weight`` (out, in);
* conv1d ``kernel`` (K, Cin, Cout) -> ``weight`` (Cout, Cin, K);
* conv2d ``kernel`` HWIO -> ``weight`` OIHW;
* LayerNorm ``scale`` -> ``weight``;
* everything else (``bias``, ``cls_tok``, ``gamma``, Time2Vec's ``w0``,
  ``b0``, ``w``, ``b``) as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_KERNEL_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (3, 2, 0, 1)}


def from_jax_params(params: Mapping) -> dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's model from flax ``params``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: tuple[str, ...]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, (*prefix, key))
                continue
            arr = np.asarray(value, np.float32)
            name = key
            if key == "kernel":
                arr = arr.transpose(_KERNEL_AXES[arr.ndim])
                name = "weight"
            elif key == "scale":
                name = "weight"
            out[".".join((*prefix, name))] = torch.from_numpy(np.array(arr, order="C"))

    walk(params, ())
    return out
