"""Package-level names imported at first use.

A package ``__init__`` lists the names it re-exports as ``{name: (module,
attribute)}`` and binds ``__getattr__, __dir__ = lazy_names(__name__,
table, globals())``: importing the package then pulls in neither the
training stack nor ``torch.distributed`` nor a kernel build, and no import
cycle forms between a package and its submodules.
"""

from __future__ import annotations

import importlib


def lazy_names(package: str, table: dict, namespace: dict):
    """(``__getattr__``, ``__dir__``) for ``package`` resolving ``table``."""

    def __getattr__(name: str):
        if name not in table:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module, attr = table[name]
        namespace[name] = value = getattr(importlib.import_module(module), attr)
        return value

    def __dir__():
        return sorted([*namespace, *table])

    return __getattr__, __dir__
