"""Config-driven run verbs (counterpart of ``applecider_tpu/train/runtime.py``):
``prepare``, ``train``, ``infer``, ``serve``, ``warmup``, ``export``
(``to_onnx``), ``engine``, ``export_serving`` and ``engine_serving``.

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

* ``export`` writes the task's ``predict`` on the infer loader's first
  batch as a ``torch.export`` program (``model.pt2``, the weights inside);
  ``engine`` runs it over the infer dataset. ``export_serving`` writes the
  whole serving forward (``infer.stream.ServingProgram``: merge,
  featurisation, normalisation with the training stats, resampling, the
  fusion model, softmax) as one program per length bucket
  (``serving_P{P}.pt2``) on ``pack_alert_batch``'s raw layout;
  ``engine_serving`` serves a raw-data directory with those programs and no
  model code. Kernels K1, K2 and K3f are custom ops (``applecider_torch::``)
  and stay nodes of the graphs, so a loaded program launches them. Each
  program takes a symbolic batch where the export allows it, else the
  concrete batch recorded in its meta file, to which the engines pad.

The verbs run on the card unless ``device="cpu"`` is asked for; an export
runs on the runtime's device and its program on that device.
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
from applecider_tpu_torch.ops import attention, ln_gelu, merge_scan  # noqa: F401  (the custom ops)
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

    # ------------------------------------------------------------- export
    def export(self, out_path: str | Path | None = None) -> Path:
        """Write the latest trained run's ``task.predict`` as a
        ``torch.export`` program, ``model.pt2`` (weights inside), traced on
        the first batch of the infer loader (the train one where no infer
        dataset is bound), with ``export_meta.json`` (``batch_size``,
        ``symbolic_batch``, ``symbolic_error`` after a fallback)."""
        if not self.datasets:
            self.prepare()
        trainer = self._restore_latest()
        task = trainer.task
        loader = self._loader(self.datasets.get("infer") or self.datasets.get("train"),
                              shuffle=False)
        out_path = Path(out_path) if out_path else self._new_run_dir("export")
        out_path.mkdir(parents=True, exist_ok=True)
        task.module.eval().requires_grad_(False)
        batch0 = trainer.to_device(task.to_tensor(next(iter(loader))))
        exported, meta = _export_with_symbolic_batch(
            _PredictProgram(task), lambda b: (batch0,), batch0[0].shape[0], batch0[0].shape[0])
        torch.export.save(exported, out_path / "model.pt2")
        (out_path / "export_meta.json").write_text(json.dumps(meta))
        return out_path

    to_onnx = export  # the reference's verb name

    def engine(self, export_dir: str | Path | None = None) -> np.ndarray:
        """``export``'s program over the infer dataset (the train one where
        no infer dataset is bound): the predictions ``infer`` returns. With
        no ``export_dir``, the latest ``*-export-*`` run directory that is
        not an ``export_serving`` one."""
        if not self.datasets:
            self.prepare()
        if export_dir:
            export_dir = Path(export_dir)
        else:
            dirs = [p for p in self.workdir.glob("*-export-*") if "-export-serving-" not in p.name]
            export_dir = sorted(dirs)[-1]
        program = torch.export.load(export_dir / "model.pt2").module()
        meta_file = export_dir / "export_meta.json"
        meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
        concrete = None if meta.get("symbolic_batch", False) else meta.get("batch_size")
        task = self._task()
        loader = self._loader(self.datasets.get("infer") or self.datasets.get("train"),
                              shuffle=False)
        outs = []
        with torch.inference_mode():
            for b in loader:
                batch = task.to_tensor(b)
                n = batch[0].shape[0]
                if concrete and n != concrete:
                    if n > concrete:
                        raise ValueError(f"batch of {n} exceeds the exported concrete batch size "
                                         f"{concrete}; re-export or lower data_loader.batch_size")
                    batch = tuple(_pad_rows(x, concrete) for x in batch)
                args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                             for x in batch)
                outs.append(program(args)[:n].float().cpu())
        return torch.cat(outs).numpy()

    def export_serving(self, out_path: str | Path | None = None,
                       length_buckets: tuple | None = None, max_spec: int = 512, params=None,
                       wave_grid=None) -> Path:
        """Write the whole serving forward, ``ServingProgram`` on
        ``pack_alert_batch``'s raw layout at ``max_spec`` spectrum points,
        as one ``torch.export`` program per length bucket
        (``serving_P{P}.pt2``, default ``[serve].length_buckets``), with the
        training stats and the horizon baked in, and ``serving_meta.json``
        (``length_buckets``, ``max_spec``, ``stats_baked_in`` and, for each
        bucket, ``batch_size``, ``symbolic_batch``, ``seconds`` of its
        export and ``symbolic_error`` after a fallback). Weights: ``params``
        (a state_dict), else the latest trained run's."""
        from applecider_tpu_torch.infer.stream import AlertStreamPipeline, pack_alert_batch

        model = self._serving_model(params)
        if length_buckets is None:  # the buckets the serve() feeder packs to
            length_buckets = tuple(self.config.get_path(
                "serve.length_buckets", default=(63, 127, 191, 255, 257)))
        mean, std = self._serve_stats()
        program = AlertStreamPipeline(model, stats_mean=mean, stats_std=std, wave_grid=wave_grid,
                                      horizon_days=self._serve_horizon(),
                                      device=self.device).program.eval()
        out_path = Path(out_path) if out_path else self._new_run_dir("export-serving")
        out_path.mkdir(parents=True, exist_ok=True)

        def raw_args(P, b):
            samples = _warmup_samples(np.random.default_rng(0), b, P)
            raw = pack_alert_batch(samples, max_photo=P, max_spec=max_spec)
            return ({k: torch.from_numpy(v).to(self.device) for k, v in raw.items()},)

        meta = {"length_buckets": [int(P) for P in length_buckets], "max_spec": int(max_spec),
                "stats_baked_in": mean is not None, "buckets": {}}
        concrete_b = int(self.config.get_path("serve.batch_size", default=1024))
        for P in length_buckets:
            t0 = time.perf_counter()
            exported, bmeta = _export_with_symbolic_batch(
                program, lambda b, P=P: raw_args(P, b), 4, concrete_b)
            torch.export.save(exported, out_path / f"serving_P{P}.pt2")
            bmeta["seconds"] = time.perf_counter() - t0
            meta["buckets"][str(P)] = bmeta
        (out_path / "serving_meta.json").write_text(json.dumps(meta))
        return out_path

    def engine_serving(self, export_dir: str | Path | None = None,
                       raw_path: str | Path | None = None, batch_size: int = 256,
                       params=None) -> dict:
        """Serve a raw-data directory with ``export_serving``'s programs: the
        alerts in arrival order, in batches of ``batch_size`` packed by
        ``pack_alert_batch`` at the bucket of their longest light curve, and
        no model code. A bucket exported at a concrete batch gets its batch
        padded to that size (the pad sliced off); a larger batch raises.
        ``params`` (a state_dict of the model) replaces the weights the
        programs carry. Returns ``serve_alert_stream``'s summary shape."""
        from applecider_tpu_torch.infer.serve import iter_alert_samples
        from applecider_tpu_torch.infer.stream import pack_alert_batch

        sec = self.config.section("serve")
        raw_path = raw_path or sec.get("data_location")
        if not raw_path:
            raise KeyError("[serve].data_location not set and no raw_path given")
        export_dir = (Path(export_dir) if export_dir
                      else sorted(self.workdir.glob("*-export-serving-*"))[-1])
        meta = json.loads((export_dir / "serving_meta.json").read_text())
        buckets = tuple(meta["length_buckets"])
        max_spec = int(meta["max_spec"])
        programs = {}
        for P in buckets:
            programs[P] = torch.export.load(export_dir / f"serving_P{P}.pt2").module()
            if params is not None:
                _load_model_params(programs[P], params)

        infos, probs, batch = [], [], []
        t0 = time.perf_counter()

        def flush():
            if not batch:
                return
            raw = pack_alert_batch([s for _, s in batch], length_buckets=buckets, max_spec=max_spec)
            P = raw["photo_t"].shape[1]
            if P not in programs:
                raise ValueError(f"a light curve of this batch needs {P} points, past the "
                                 f"exported buckets {buckets}")
            bmeta = meta["buckets"][str(P)]
            n = len(batch)
            if not bmeta["symbolic_batch"]:
                cb = int(bmeta["batch_size"])
                if n > cb:
                    raise ValueError(f"batch of {n} exceeds bucket P={P}'s concrete exported "
                                     f"batch size {cb}; lower batch_size or re-export with a "
                                     "symbolic batch")
                raw = {k: _pad_rows(v, cb) for k, v in raw.items()}
            with torch.inference_mode():
                out = programs[P]({k: torch.from_numpy(v).to(self.device) for k, v in raw.items()})
            out = out[:n].float().cpu().numpy()
            for j, (info, _) in enumerate(batch):
                infos.append(info)
                probs.append(out[j])
            batch.clear()

        for pair in iter_alert_samples(raw_path,
                                       causal_spectrum=bool(sec.get("causal_spectrum", True))):
            batch.append(pair)
            if len(batch) >= batch_size:
                flush()
        flush()
        elapsed = time.perf_counter() - t0
        results = [dict(info, probs=np.asarray(p, np.float32)) for info, p in zip(infos, probs)]
        return {"n_alerts": len(results), "seconds": elapsed,
                "alerts_per_sec": len(results) / elapsed if elapsed > 0 else 0.0,
                "results": results}

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


class _PredictProgram(torch.nn.Module):
    """A task's ``predict`` on a ``to_tensor`` batch (labels included) as a
    module forward, the model under ``model``, for ``torch.export``."""

    def __init__(self, task: Task):
        super().__init__()
        self.model = task.module
        self.task = task

    def forward(self, batch: tuple[torch.Tensor, ...]) -> torch.Tensor:
        return self.task.predict(batch)


def _export_with_symbolic_batch(module: torch.nn.Module, make_args, example_b: int,
                                concrete_b: int):
    """``torch.export`` of ``module`` on ``make_args(b)`` (a tuple) with a
    symbolic batch over every leading dimension of ``example_b`` rows;
    where that export fails, one at ``concrete_b`` rows. Returns
    (ExportedProgram, meta)."""
    meta = {"batch_size": int(concrete_b)}
    try:
        batch = torch.export.Dim("batch", min=1)
        args = make_args(example_b)
        dims = torch.utils._pytree.tree_map(
            lambda t: {0: batch} if t.dim() and t.shape[0] == example_b else None, args)
        exported = torch.export.export(module, args, dynamic_shapes=dims, strict=False)
        meta["symbolic_batch"] = True
    except Exception as e:  # noqa: BLE001 — the fallback is recorded, as the JAX runtime does
        exported = torch.export.export(module, make_args(concrete_b), strict=False)
        meta["symbolic_batch"] = False
        meta["symbolic_error"] = f"{type(e).__name__}: {e}"
    return exported, meta


def _load_model_params(program: torch.nn.Module, params: dict) -> None:
    """Load a model state_dict into a loaded program, which keeps the model
    under ``model.``; every key of ``params`` must land."""
    result = program.load_state_dict({f"model.{k}": v for k, v in params.items()}, strict=False)
    missing = [k for k in result.missing_keys if k.startswith("model.")]
    if result.unexpected_keys or missing:
        raise KeyError(f"params do not fit the program: unexpected {result.unexpected_keys}, "
                       f"missing {missing}")


def _pad_rows(x: np.ndarray, n: int) -> np.ndarray:
    """``x`` with its last row repeated up to ``n`` rows."""
    return np.concatenate([x, np.repeat(x[-1:], n - x.shape[0], axis=0)])


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
