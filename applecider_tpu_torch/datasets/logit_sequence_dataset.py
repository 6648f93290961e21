"""Per-object sequences of per-alert model outputs, for a late-fusion
combiner (the port's copy of
``applecider_tpu/datasets/logit_sequence_dataset.py``): each object's (T, D)
sequence is cut to ``max_len`` and padded with zeros in ``collate``, with a
boolean ``pad_mask`` (True = padding).

Tables are ``.npz`` {sequences (ragged, object array), labels}, or ``.pt``
tables read with ``torch.load(weights_only=False)`` as the JAX package reads
them (a pickle: load only tables you trust).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from applecider_tpu_torch.registry import register_dataset


@register_dataset(name="LogitSequenceDataset")
class LogitSequenceDataset:
    SECTION = "applecider_tpu.datasets.logit_sequence_dataset.LogitSequenceDataset"

    def __init__(self, config, data_location, max_len: int = 10):
        section = config.section("data_set", self.SECTION)
        self.max_len = int(section.get("max_len", max_len))
        path = Path(data_location)
        if path.suffix == ".pt":
            import torch

            table = torch.load(path, weights_only=False)
            self._seqs = [np.asarray(s, np.float32) for s in table["sequences"]]
            self._labels = np.asarray(table["labels"], np.int64)
        else:
            with np.load(path, allow_pickle=True) as npz:
                self._seqs = [np.asarray(s, np.float32) for s in npz["sequences"]]
                self._labels = np.asarray(npz["labels"], np.int64)

    def __len__(self) -> int:
        return len(self._seqs)

    def sample(self, idx: int) -> dict:
        return {"sequence": self._seqs[idx][: self.max_len], "label": int(self._labels[idx])}

    def collate(self, samples: list[dict]) -> dict:
        dim = samples[0]["sequence"].shape[-1]
        batch = np.zeros((len(samples), self.max_len, dim), np.float32)
        mask = np.ones((len(samples), self.max_len), bool)
        for i, s in enumerate(samples):
            n = len(s["sequence"])
            batch[i, :n] = s["sequence"]
            mask[i, :n] = False
        return {"data": {
            "sequence": batch,
            "pad_mask": mask,
            "label": np.asarray([s["label"] for s in samples], np.int64),
        }}


register_dataset(LogitSequenceDataset, name=LogitSequenceDataset.SECTION)
