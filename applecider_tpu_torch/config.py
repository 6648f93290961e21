"""The port's configuration (counterpart of ``applecider_tpu/config.py``):
its own copy of the package defaults, read with ``tomllib``, a per-run TOML
file deep-merged on top, then programmatic overrides, in a nested dict with
dotted-path access (``cfg.set("model.BaselineCLS.d_model", 16)``).

Dotted paths treat quoted segments as single keys, so dataset sections keyed
by a full class path work:
``cfg.get_path('data_set."applecider_tpu.datasets.fusion_dataset.FusionDataset".horizon')``.
The section names are the JAX package's, so that one run TOML drives both
packages.
"""

from __future__ import annotations

import copy
import tomllib
from pathlib import Path
from typing import Any, Mapping

import torch

_DEFAULT_CONFIG_PATH = Path(__file__).parent / "default_config.toml"


def _deep_merge(base: dict, overlay: Mapping) -> dict:
    """Recursively merge ``overlay`` into ``base`` (overlay wins). Returns base."""
    for key, value in overlay.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, Mapping):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value) if isinstance(value, (dict, list)) else value
    return base


class Config(dict):
    """A nested dict with dotted-path ``get_path``, ``set``, ``merged_with``
    and ``section``."""

    @staticmethod
    def _split(path: str) -> list[str]:
        parts: list[str] = []
        buf = ""
        in_quote = False
        for ch in path:
            if ch == '"':
                in_quote = not in_quote
            elif ch == "." and not in_quote:
                parts.append(buf)
                buf = ""
            else:
                buf += ch
        parts.append(buf)
        return [p for p in parts if p]

    def get_path(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in self._split(path):
            if not isinstance(node, Mapping) or part not in node:
                if default is ...:
                    raise KeyError(path)
                return default
            node = node[part]
        return node

    def set(self, path: str, value: Any) -> None:
        """Set a dotted-path key, creating intermediate tables as needed."""
        parts = self._split(path)
        node: dict = self
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value

    def merged_with(self, overlay: Mapping) -> "Config":
        merged = copy.deepcopy(dict(self))
        _deep_merge(merged, overlay)
        return Config(merged)

    def section(self, *keys: str, default: Any = None) -> "Config":
        """A nested section as a Config (empty if missing)."""
        node: Any = self
        for key in keys:
            if not isinstance(node, Mapping) or key not in node:
                return Config(default or {})
            node = node[key]
        return Config(node) if isinstance(node, Mapping) else node


def load_defaults() -> Config:
    with open(_DEFAULT_CONFIG_PATH, "rb") as f:
        return Config(tomllib.load(f))


def load_config(config_file: str | Path | None = None, overrides: Mapping | None = None) -> Config:
    """Package defaults, then a per-run TOML file, then ``overrides``."""
    cfg = load_defaults()
    if config_file is not None:
        with open(config_file, "rb") as f:
            cfg = cfg.merged_with(tomllib.load(f))
    if overrides:
        cfg = cfg.merged_with(overrides)
    return cfg


def compute_dtype(cfg: Config) -> torch.dtype:
    """``train.compute_dtype``: bfloat16 (serving) or float32 (parity)."""
    name = str(cfg.get_path("train.compute_dtype", "bfloat16"))
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"train.compute_dtype must be bfloat16 or float32, got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32
