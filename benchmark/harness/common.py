"""What the runners share: the program's configuration from a cell's
configuration file, the seeds of a run, and the device."""

from __future__ import annotations

import numpy as np
import torch

# the sections of the program's configuration that a configuration file sets
SECTIONS = ("model", "train", "serve", "data_set", "data_loader")


def port_config(config: dict):
    """The program's defaults with the configuration file's tables on top."""
    from applecider_tpu_torch.config import load_defaults

    return load_defaults().merged_with({k: config[k] for k in SECTIONS if k in config})


def seeds(seed: int, n: int = 5) -> list[int]:
    """``n`` independent 32-bit seeds drawn from the run's seed: weights,
    traffic, order or trainer, sample, spare."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def build_task(cfg, device):
    """The program's task for ``model.name``, built as its runtime builds it
    (the fusion model's factory wrapped in its task), its modules made on
    ``device``."""
    from applecider_tpu_torch.models.base import Task
    from applecider_tpu_torch.models.fusion import AppleCiderTask
    from applecider_tpu_torch.registry import get_model

    with torch.device(device):
        built = get_model(cfg["model"]["name"])(cfg, device=device)
    return built if isinstance(built, Task) else AppleCiderTask(cfg, built)


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
