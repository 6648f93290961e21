"""The port's configuration: its own copy of the model defaults, read with
``tomllib``, in a nested dict with dotted-path access (the same surface as
``applecider_tpu.config``: ``cfg.set("model.BaselineCLS.d_model", 16)``)."""

from __future__ import annotations

import tomllib
from pathlib import Path
from typing import Any, Mapping

import torch

_DEFAULT_CONFIG_PATH = Path(__file__).parent / "default_config.toml"


class Config(dict):
    """A nested dict with dotted-path ``get_path`` and ``set``."""

    def get_path(self, path: str, default: Any = ...) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, Mapping) or part not in node:
                if default is ...:
                    raise KeyError(path)
                return default
            node = node[part]
        return node

    def set(self, path: str, value: Any) -> None:
        """Set a dotted-path key, creating intermediate tables as needed."""
        parts = path.split(".")
        node: dict = self
        for part in parts[:-1]:
            if not isinstance(node.get(part), dict):
                node[part] = {}
            node = node[part]
        node[parts[-1]] = value


def load_defaults() -> Config:
    with open(_DEFAULT_CONFIG_PATH, "rb") as f:
        return Config(tomllib.load(f))


def compute_dtype(cfg: Config) -> torch.dtype:
    """``train.compute_dtype``: bfloat16 (serving) or float32 (parity)."""
    name = str(cfg.get_path("train.compute_dtype", "bfloat16"))
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"train.compute_dtype must be bfloat16 or float32, got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32
