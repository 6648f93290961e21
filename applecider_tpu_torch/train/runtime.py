"""Config-driven run verbs (counterpart of ``applecider_tpu/train/runtime.py``):
``prepare``, ``train``, ``infer``, ``serve`` and ``warmup``.

* The task and the per-phase datasets come from the TOML config
  (``model.name``; ``[model_inputs.<phase>.data]`` with ``dataset_class``
  and ``data_location``) through the port's registry; ``set_config``
  changes a key. ``train`` and ``infer`` run any registered task, so
  every run config of ``configs/`` trains and infers: the fusion model
  (``fusion.toml``, with either spectra encoder), ``BaselineCLS`` and
  ``MPT`` (``photometry.toml``), ``SpectraNet`` (``spectra.toml``; with
  ``model.SpectraNet.redshift`` the redshift regressor; ``model.name =
  "SpectraNetTriPool"`` the TriPool classifier on the same data) and
  ``AstroMiNN`` (``astrominn.toml``, on the samples that
  ``preprocessing.alert_samples.build_alert_samples`` writes). ``serve``
  and ``warmup`` run the fusion model and refuse another.
* Each verb writes into a timestamped run directory under ``workdir``;
  ``infer`` and ``serve`` load the weights of the most recent trained run
  (``checkpoints/best.pt``, else ``last.pt``), built from the config alone:
  no data batch is needed to restore.
* ``serve`` classifies every alert of a raw-data directory with
  ``infer.serve.serve_alert_stream``, normalising with the training stats.
* ``warmup`` builds the CUDA kernels and runs each configured length bucket
  at every configured spectra bucket of ``FusedSpectraStream`` once, so
  that a fresh process pays its first-use costs before traffic arrives.

The verbs run on the card unless ``device="cpu"`` is asked for. The JAX
runtime's ``export``, ``export_serving``, ``engine_serving`` and ``engine``
are ``jax.export`` programs; their ``torch.export`` counterparts are
ROADMAP.md Queue A item 4 and are not here.
"""

from __future__ import annotations

import datetime as _dt
import json
import time
import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from applecider_tpu_torch.config import Config, load_config
from applecider_tpu_torch.datasets.fusion_dataset import FusionDataset
from applecider_tpu_torch.datasets.loader import DataLoader
from applecider_tpu_torch.datasets.photo_dataset import load_photo_stats
from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.models.base import Task
from applecider_tpu_torch.models.fusion import AppleCiderTask
from applecider_tpu_torch.registry import get_dataset_class, get_model
from applecider_tpu_torch.train.trainer import Trainer, refuse_unported


class AppleCiderRuntime:
    def __init__(self, config_file=None, overrides=None, workdir: str | Path | None = None,
                 device="cuda"):
        self.config: Config = load_config(config_file, overrides)
        self.device = resolve_device(device)
        self.workdir = Path(workdir or self.config.get_path("run.output_dir", default="./results"))
        self.datasets: dict = {}
        self._run_dir: Optional[Path] = None

    def set_config(self, path: str, value) -> None:
        self.config.set(path, value)

    # ----------------------------------------------------------- components
    def _task(self) -> Task:
        """The configured task, its weights drawn from ``train.seed``; the
        fusion model's factory is wrapped in ``AppleCiderTask``."""
        name = self.config.get_path("model.name", default="BaselineCLS")
        seed = int(self.config.get_path("train.seed", 42))
        built = get_model(name)(self.config, device=self.device,
                                generator=torch.Generator().manual_seed(seed))
        return built if isinstance(built, Task) else AppleCiderTask(self.config, built)

    def _fusion_task(self) -> AppleCiderTask:
        """``_task()``, which must be the fusion model: serving runs it alone."""
        task = self._task()
        if not isinstance(task, AppleCiderTask):
            raise ValueError(
                f"serve and warmup run the AppleCider fusion model; model.name = "
                f"{self.config.get_path('model.name', default='BaselineCLS')!r} builds "
                f"{type(task).__name__}")
        return task

    def _dataset(self, phase: str):
        section = self.config.section("model_inputs", phase, "data")
        cls_name = section.get("dataset_class")
        if not cls_name:
            raise KeyError(f"[model_inputs.{phase}.data].dataset_class not set")
        ds_cls = get_dataset_class(cls_name)
        location = section.get("data_location") or None
        return ds_cls(self.config, location) if location else ds_cls(self.config)

    def _loader(self, dataset, shuffle: bool) -> DataLoader:
        refuse_unported(self.config)
        dl = self.config.section("data_loader")
        return DataLoader(dataset, batch_size=int(dl.get("batch_size", 32)),
                          shuffle=shuffle and bool(dl.get("shuffle", True)),
                          seed=int(dl.get("seed", 42)), drop_last=bool(dl.get("drop_last", False)))

    # ---------------------------------------------------------------- verbs
    def prepare(self) -> dict:
        """Instantiate the datasets bound to each configured phase."""
        for phase in ("train", "validate", "infer"):
            if self.config.section("model_inputs", phase, "data").get("dataset_class"):
                self.datasets[phase] = self._dataset(phase)
        return self.datasets

    def _new_run_dir(self, verb: str) -> Path:
        stamp = _dt.datetime.now().strftime("%Y%m%d-%H%M%S-%f")
        name = str(self.config.get_path("model.name", default="model")).split(".")[-1]
        run_dir = self.workdir / f"{stamp}-{verb}-{name}"
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "run.json").write_text(json.dumps({"verb": verb, "model": name,
                                                      "timestamp": stamp}))
        return run_dir

    def _latest_run_dir(self) -> Path:
        candidates = sorted(d for d in self.workdir.glob("*-train-*")
                            if (d / "checkpoints").exists())
        if not candidates:
            raise FileNotFoundError(f"no trained run under {self.workdir}")
        return candidates[-1]

    def train(self, init_params: dict | None = None) -> dict:
        """Fit the configured task on the train dataset, validating on the
        validate one where bound; ``init_params`` (a state_dict, e.g.
        ``models.mpt.warmstart_classifier_params``'s) are its starting
        weights in place of the drawn ones."""
        if "train" not in self.datasets:
            self.prepare()
        task = self._task()
        self._run_dir = self._new_run_dir("train")
        trainer = Trainer(task, self.config, self._run_dir, device=self.device)
        train_loader = self._loader(self.datasets["train"], shuffle=True)
        val_loader = (self._loader(self.datasets["validate"], shuffle=False)
                      if "validate" in self.datasets else None)
        results = trainer.fit(train_loader, val_loader, init_params=init_params)
        results["run_dir"] = self._run_dir
        return results

    def _restore_latest(self, task: Task | None = None) -> Trainer:
        """A Trainer over ``task`` (default: a fresh one) holding the latest
        trained run's weights (``best``, else ``last``)."""
        run_dir = self._run_dir or self._latest_run_dir()
        trainer = Trainer(task or self._task(), self.config, run_dir, device=self.device)
        trainer.restore_weights()
        return trainer

    def infer(self, kernels: bool = True) -> np.ndarray:
        """Predictions of the most recently trained weights over the infer
        dataset (the train one where no infer dataset is bound), in its
        order; also written to ``predictions.npy``."""
        if not self.datasets:
            self.prepare()
        trainer = self._restore_latest()
        ds = self.datasets.get("infer") or self.datasets.get("train")
        loader = self._loader(ds, shuffle=False)
        out_dir = self._new_run_dir("infer")
        preds = trainer.predict(loader, kernels=kernels)
        np.save(out_dir / "predictions.npy", preds)
        return preds

    # -------------------------------------------------------------- serving
    def _serve_stats(self):
        """(mean, std) photometry normalization from [serve].stats_event_path,
        falling back to the fusion dataset's training stats (the model was
        trained with these)."""
        stats_path = self.config.section("serve").get("stats_event_path", "")
        if not stats_path:
            stats_path = self.config.section("data_set", FusionDataset.SECTION).get(
                "stats_event_path", "")
        if not stats_path:
            return None, None
        return load_photo_stats(stats_path)

    def _serve_horizon(self) -> Optional[float]:
        """Horizon cut (days) of the serving featurization: ``[serve].
        horizon_days`` ("" or "none": off), else the fusion dataset's
        ``horizon`` (default 100), as training cut it."""
        sec = self.config.section("serve")
        if "horizon_days" in sec:
            v = sec.get("horizon_days")
            return None if v in ("", "none", None) else float(v)
        return float(self.config.section("data_set", FusionDataset.SECTION).get("horizon", 100.0))

    def _serving_model(self, params=None) -> torch.nn.Module:
        """The fusion model for serving: ``params`` (a state_dict) if given,
        else the latest trained run's weights; eval mode, no gradients."""
        task = self._fusion_task()
        if params is None:
            self._restore_latest(task)
        else:
            task.module.load_state_dict(params)
        return task.module.eval().requires_grad_(False)

    def serve(self, raw_path: str | Path | None = None, params=None) -> dict:
        """Classify every alert of a raw-data directory, per-alert causal.

        Config under ``[serve]``: ``data_location`` (the raw dir; the
        ``raw_path`` argument wins), ``batch_size``, ``binned``,
        ``length_buckets``, ``causal_spectrum``, ``stats_event_path``,
        ``horizon_days``. Weights: ``params`` (a state_dict), else the most
        recent trained run's. Writes ``alerts.jsonl`` and ``serve.json``
        into a timestamped run dir; returns the summary of
        ``serve_alert_stream`` with ``run_dir``.
        """
        from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream

        sec = self.config.section("serve")
        if bool(sec.get("int8", False)):
            raise NotImplementedError(
                "serve.int8 = true is not ported to applecider_tpu_torch yet "
                "(ROADMAP.md Queue A item 4, int8 serving)")
        raw_path = raw_path or sec.get("data_location")
        if not raw_path:
            raise KeyError("[serve].data_location not set and no raw_path given")
        model = self._serving_model(params)
        mean, std = self._serve_stats()
        out_dir = self._new_run_dir("serve")
        summary = serve_alert_stream(
            model,
            iter_alert_samples(raw_path, causal_spectrum=bool(sec.get("causal_spectrum", True))),
            batch_size=int(sec.get("batch_size", 1024)),
            binned=bool(sec.get("binned", True)),
            length_buckets=tuple(sec.get("length_buckets", (63, 127, 191, 255, 257))),
            stats_mean=mean,
            stats_std=std,
            out_jsonl=out_dir / "alerts.jsonl",
            horizon_days=self._serve_horizon(),
            device=self.device,
        )
        (out_dir / "serve.json").write_text(json.dumps(
            {k: v for k, v in summary.items() if k != "results"}))
        summary["run_dir"] = out_dir
        return summary

    def warmup(self, params=None, batch_size: int | None = None) -> dict:
        """Pay a fresh process's first-use costs before traffic arrives.

        On the card it builds every CUDA kernel (``nvcc`` at first use,
        cached under ``build/kernels``), then runs one batch of
        ``batch_size`` (default ``[serve].batch_size``) synthetic alerts at
        each configured length bucket with each configured spectra bucket
        of ``FusedSpectraStream.spec_buckets`` up to the batch size (a
        batch whose spectra count is the bucket), so that every shape the
        serving path can take has been launched once. Weights: ``params``,
        else the latest trained run's, else (with a warning naming why)
        random ones: the values do not change what is built or launched.

        Returns ``{"build_seconds", "programs": [{"length_bucket",
        "spectra_bucket", "batch", "seconds"}], "total_seconds"}``.
        """
        from applecider_tpu_torch.infer.stream import FusedSpectraStream
        from applecider_tpu_torch.ops import kernel

        t_all = time.perf_counter()
        build_s = 0.0
        if self.device.type == "cuda":
            kernel.build()
            build_s = time.perf_counter() - t_all
        try:
            model = self._serving_model(params)
        except FileNotFoundError as e:
            warnings.warn(f"warmup runs with random weights: {e}", stacklevel=2)
            model = self._fusion_task().module.eval().requires_grad_(False)
        sec = self.config.section("serve")
        bs = int(batch_size or sec.get("batch_size", 1024))
        buckets = tuple(sec.get("length_buckets", (63, 127, 191, 255, 257)))
        mean, std = self._serve_stats()
        router = FusedSpectraStream(model, stats_mean=mean, stats_std=std,
                                    horizon_days=self._serve_horizon(), device=self.device)
        rng = np.random.default_rng(0)
        programs = []
        for P in buckets:
            samples = _warmup_samples(rng, bs, P)
            for n_spec in (b for b in router.spec_buckets if b <= bs):
                batch = [s if i < n_spec else _without_spectrum(s) for i, s in enumerate(samples)]
                t0 = time.perf_counter()
                out = router.run_placed(router.place(batch, length_buckets=(P,)))()
                seconds = time.perf_counter() - t0
                if not np.isfinite(out).all():
                    raise RuntimeError(f"warmup: non-finite output at P={P} spectra={n_spec}")
                programs.append({"length_bucket": int(P), "spectra_bucket": int(n_spec),
                                 "batch": bs, "seconds": seconds})
        return {"build_seconds": build_s, "programs": programs,
                "total_seconds": time.perf_counter() - t_all}


def _warmup_samples(rng: np.random.Generator, n: int, P: int) -> list[dict]:
    """``n`` alerts of light-curve lengths in [P/2, P], each with a spectrum."""
    out = []
    for _ in range(n):
        L = max(2, min(P, int(rng.integers(max(2, P // 2), P + 1))))
        m = int(rng.integers(200, 500))
        out.append({
            "photo_t": np.sort(rng.uniform(0, 60, L)).astype(np.float32),
            "photo_flux": rng.lognormal(2.0, 1.0, L).astype(np.float32),
            "photo_err": rng.uniform(0.1, 2.0, L).astype(np.float32),
            "photo_band": rng.integers(0, 3, L).astype(np.int32),
            "image": rng.normal(size=(63, 63, 3)).astype(np.float32),
            "meta19": rng.normal(size=19).astype(np.float32),
            "spec_wl": np.linspace(4000.0, 8500.0, m).astype(np.float32),
            "spec_flux": rng.normal(1.0, 0.3, m).astype(np.float32),
        })
    return out


def _without_spectrum(sample: dict) -> dict:
    return {k: v for k, v in sample.items() if not k.startswith("spec_")}
