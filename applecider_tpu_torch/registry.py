"""Model and dataset registries (counterpart of ``applecider_tpu/registry.py``).

Models and datasets register under a short name and their full dotted path,
so run configs select them either way. The port registers what it has:

* ``"AppleCider"`` and ``"Fusion"``: ``models.fusion.build_fusion_model``,
  the factory of the port's ``AppleCiderModule`` (``factory(cfg, device=,
  generator=)``), which ``AppleCiderTask`` wraps for training;
* tasks, built the same way: ``"BaselineCLS"`` and ``"HyraxBaselineCLS"``
  (``models.baseline_cls.BaselineCLSTask``), ``"MPT"`` and ``"MPTModel"``
  (``models.mpt.MPTTask``), ``"SpectraNet"`` and ``"SpectraNetTriPool"``
  (``models.spectranet``), ``"AstroMiNN"`` (``models.astrominn``);
* datasets: ``"FusionDataset"`` and ``"CiDErDataset"``,
  ``"PhotoEventsDataset"``, ``"SpectraDataset"`` and ``"SpectraData"``,
  ``"ImageAndMetadataDataset"``, ``"LogitSequenceDataset"``.

The JAX package's dotted names of these (``applecider_tpu.models.fusion.
AppleCiderTask``, ``applecider_tpu.models.spectranet.SpectraNetTask``,
``applecider_tpu.datasets.spectra_dataset.SpectraDataset``, ...) map to
them, so the same run TOML drives both packages. Any other dotted name
under ``applecider_tpu.`` raises ``KeyError``: the port never imports the
JAX package. A short name the JAX package registers but the port has not
ported yet (the model zoo's) raises ``NotImplementedError`` naming its
ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

_MODEL_REGISTRY: dict[str, Any] = {}
_DATASET_REGISTRY: dict[str, Any] = {}

# the port's modules that register entries, imported on a registry miss
_MODEL_MODULES = ["applecider_tpu_torch.models.fusion", "applecider_tpu_torch.models.baseline_cls",
                  "applecider_tpu_torch.models.mpt", "applecider_tpu_torch.models.spectranet",
                  "applecider_tpu_torch.models.astrominn"]
_DATASET_MODULES = ["applecider_tpu_torch.datasets.fusion_dataset",
                    "applecider_tpu_torch.datasets.photo_dataset",
                    "applecider_tpu_torch.datasets.spectra_dataset",
                    "applecider_tpu_torch.datasets.image_metadata_dataset",
                    "applecider_tpu_torch.datasets.logit_sequence_dataset"]

_UNPORTED_MODELS = {
    name: "ROADMAP.md Queue A item 7 (models/zoo.py)" for name in (
        "BTSModel", "GalSpecNet", "MetaModel", "Informer", "SpectraViT",
        "SpectraEfficientNetV2", "SpectraConvNeXt")
}
_UNPORTED_DATASETS: dict[str, str] = {}


def _register(registry: dict, obj: Any, name: str | None) -> Any:
    registry[name or obj.__name__] = obj
    registry[f"{obj.__module__}.{obj.__name__}"] = obj
    return obj


def register_model(obj: Any = None, *, name: str | None = None) -> Any:
    """Register a model factory under ``name`` and its dotted path."""
    if obj is None:
        return lambda o: _register(_MODEL_REGISTRY, o, name)
    return _register(_MODEL_REGISTRY, obj, name)


def register_dataset(cls: Any = None, *, name: str | None = None) -> Any:
    """Register a dataset class under ``name`` and its dotted path."""
    if cls is None:
        return lambda c: _register(_DATASET_REGISTRY, c, name)
    return _register(_DATASET_REGISTRY, cls, name)


def _resolve(registry: dict, name: str, modules: list[str], unported: dict[str, str],
             kind: str) -> Any:
    if name in registry:
        return registry[name]
    for module_name in modules:
        importlib.import_module(module_name)
        if name in registry:
            return registry[name]
    if name in unported:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to applecider_tpu_torch yet: {unported[name]}")
    known = sorted(k for k in registry if "." not in k)
    short = name.rpartition(".")[2]
    why = f" ({short} is not ported yet: {unported[short]})" if short in unported else ""
    raise KeyError(f"Unknown {kind} {name!r} in applecider_tpu_torch{why}; the port never "
                   f"imports the JAX package. Known: {known}")


def get_model(name: str) -> Callable:
    """The model factory or task class registered under ``name``:
    ``factory(cfg, device=, generator=)``."""
    return _resolve(_MODEL_REGISTRY, name, _MODEL_MODULES, _UNPORTED_MODELS, "model")


def get_dataset_class(name: str) -> type:
    return _resolve(_DATASET_REGISTRY, name, _DATASET_MODULES, _UNPORTED_DATASETS, "dataset")


def builder_from_config(config, phase: str = "train") -> type:
    """The dataset class bound to a run phase under
    ``[model_inputs.<phase>.data].dataset_class``."""
    section = config.section("model_inputs", phase, "data")
    name = section.get("dataset_class")
    if not name:
        raise KeyError(f"No dataset_class bound for phase {phase!r} under [model_inputs.{phase}.data]")
    return get_dataset_class(name)
