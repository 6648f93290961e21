"""Runner of ``alert_stream`` traffic: a backlog of alerts served through
the program's length-binned feeder and fused-spectra stream.

One producer hands the alerts of a seeded pool, in a seeded order and
cycled, to ``LengthBinnedFeeder.submit`` one at a time for the window's
length, then flushes the partial batches and drains. As the program's
``serve_alert_stream`` does, one batch stays in flight: a batch is read back
once the next one is enqueued. Each alert is timed from its hand-off to the
return of its batch's read-back.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, spec, traffic, weights
from benchmark.reference import layers as ref_layers
from benchmark.reference import preprocess

CHECKED = 256  # alerts drawn from the seed for the check, beside the longest
TIE = 0.01     # router gates nearer than this: a routing that a rounding can flip


class Runner:
    def __init__(self, cell: spec.Cell, device):
        from applecider_tpu_torch.infer.stream import FusedSpectraStream, LengthBinnedFeeder

        self.cell, self.device = cell, torch.device(device)
        self.cfg = common.port_config(cell.config)
        serve = self.cfg["serve"]
        self.batch = int(serve["batch_size"])
        self.buckets = tuple(int(b) for b in serve["length_buckets"])
        self.horizon = float(self.cfg.get_path(
            'data_set."applecider_tpu.datasets.fusion_dataset.FusionDataset".horizon', 100.0))
        self.task = common.build_task(self.cfg, self.device)
        self.model = self.task.module
        self.shapes = weights.shapes_of(self.model)
        t = cell.traffic
        self.stats = (np.asarray(t["stats_mean"], np.float32), np.asarray(t["stats_std"], np.float32))
        self._stream_cls, self._feeder_cls = FusedSpectraStream, LengthBinnedFeeder
        self.ref = spec.reference(cell.config["name"])

    def _router(self, scales=None):
        return self._stream_cls(self.model, stats_mean=self.stats[0], stats_std=self.stats[1],
                                horizon_days=self.horizon, device=self.device,
                                quantize_scales=scales)

    def roots(self) -> dict:
        return {"router": self.router, "program": self.router.pipe.program, "model": self.model}

    # ---------------------------------------------------------------- set-up
    def prepare(self, seed: int, fault=None) -> None:
        """Weights, the alert pool and its order from ``seed``, then one
        batch of every shape the traffic can reach. ``fault(runner)``, if
        given, then breaks the program."""
        self.seed = seed
        s_weights, s_traffic, s_order, s_sample, _ = common.seeds(seed)
        weights.load(self.model, weights.make_state(self.shapes, s_weights, self.device))
        self.router = self._router()
        self.pool = traffic.alert_pool(self.cell.traffic, s_traffic)
        self.order = np.random.default_rng(s_order).permutation(len(self.pool))
        self.sample_seed = s_sample
        self.points = np.array([len(a["photo_t"]) for a in self.pool])
        self.spec_points = np.array([len(a.get("spec_wl", ())) for a in self.pool])
        self.warm()
        if fault is not None:
            fault(self)

    def warm(self) -> None:
        """One batch of ``batch`` rows at every length bucket and at every
        spectra-block size, packed as the feeder packs them."""
        sizes = self.router.spec_buckets
        for j in range(max(len(sizes), len(self.buckets))):
            b = self.buckets[j % len(self.buckets)]
            fits = self.points <= b
            spec = np.flatnonzero(fits & (self.spec_points > 0))
            plain = np.flatnonzero(fits & (self.spec_points == 0))
            n_spec = min(sizes[j % len(sizes)], self.batch) if len(spec) else 0
            idx = np.concatenate([np.resize(spec, n_spec), np.resize(plain, self.batch - n_spec)])
            self.router.run_placed(self.router.place([self.pool[i] for i in idx],
                                                     length_buckets=(b,)))()

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, tick=None) -> dict:
        """Serve for ``seconds``; ``tick()``, if given, is called after each
        hand-off (the traced run's profiler stops in it)."""
        feeder = self._feeder_cls(self.router, flush_bs=self.batch, length_buckets=self.buckets,
                                  device=self.device)
        cap = 1 << 22
        submitted = np.zeros(cap)
        done = np.full(cap, np.nan)
        probs = np.zeros((cap, int(self.model.num_classes)), np.float32)
        pending: list = []
        n_batches = 0

        def resolve_oldest():
            idxs, res = pending.pop(0)
            out = res()
            now = time.perf_counter()
            probs[idxs] = out
            done[idxs] = now

        def drain(ready):
            nonlocal n_batches
            for entry in ready:
                n_batches += 1
                pending.append(entry)
                while len(pending) > 1:
                    resolve_oldest()

        pool, order, n_pool = self.pool, self.order, len(self.order)
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds and k < cap:
            submitted[k] = time.perf_counter()
            drain(feeder.submit([(k, pool[order[k % n_pool]])]))
            k += 1
            if tick is not None:
                tick()
        drain(feeder.flush())
        while pending:
            resolve_oldest()
        t1 = time.perf_counter()
        self.served = k
        self.probs = probs[:k]
        latency = done[:k] - submitted[:k]
        failed = int(np.isnan(latency).sum())
        lat_ms = np.where(np.isnan(latency), np.inf, latency) * 1e3
        served = order[np.arange(k) % n_pool][~np.isnan(latency)]
        key, count = np.unique(self.points[served] * 2 + (self.spec_points[served] > 0),
                               return_counts=True)
        flops = sum(c * self.ref.forward_flops(self.cell.config, int(x // 2), bool(x % 2))
                    for x, c in zip(key, count))
        return {
            "attempted": k, "failed": failed, "window_s": t1 - t0, "batches": n_batches,
            "e2e": {"alerts_per_s": (k - failed) / (t1 - t0),
                    "alert_p95_ms": float(np.percentile(lat_ms, 95, method="linear"))},
            "work": {"flops": float(flops), "items": k - failed},
        }

    def release(self) -> None:
        self.router = self.task = self.model = None
        common.free(self.device)

    # ----------------------------------------------------------------- check
    def control(self, seconds: float, name: str = "fp8") -> dict:
        """The check's numbers with a lower precision in the program's place.
        ``fp8``: the reference with its products rounded to float8, read at
        the alerts that a window of the program served. ``int8``: the
        program's own int8 path serving a window, its activation scales
        calibrated on the pool's first alerts (as
        ``serve_alert_stream(int8=True)`` calibrates them)."""
        if name == "int8":
            head = [self.pool[i] for i in self.order[:64]]
            scales = self.router.pipe.calibrate([self.router.place(head,
                                                                   length_buckets=self.buckets)])
            self.router = self._router(scales)
            self.warm()
            self.window(seconds)
            return self.check()
        if name != "fp8":
            raise ValueError(f"control {name!r}: expected fp8 or int8")
        self.window(seconds)
        return self.check(lower=lambda picks: self.reference(picks, "fp8")[0])

    def reference(self, picks: list, prec: str):
        """The reference's class log-probabilities of the alerts served at
        ``picks``, in ``prec``, and how clear each alert's routing is (its
        second and third expert gates apart)."""
        alerts = self.order[np.asarray(picks) % len(self.order)]
        model = self.ref.build(self.cell.config).to(self.device)
        model.load_state_dict(weights.make_state(weights.shapes_of(model),
                                                 common.seeds(self.seed)[0], self.device))
        model.configure(ref_layers.Precision(prec), None).eval()
        logp, margin = [], []
        with torch.no_grad(), ref_layers.no_tf32():
            for j in range(0, len(picks), 64):
                block = [preprocess.alert_inputs(self.pool[a], self.horizon, *self.stats)
                         for a in alerts[j: j + 64]]
                logits = model(*self.ref.serve_batch(block, self.device))
                logp.append(torch.log_softmax(logits, dim=-1).double().cpu().numpy())
                gates = model.img_meta_encoder.gates.sort(dim=-1, descending=True).values
                margin.append((gates[:, 1] - gates[:, 2]).cpu().numpy())
        return np.concatenate(logp), np.concatenate(margin)

    def picks(self) -> list:
        """The served alerts that the check compares: a sample drawn from the
        seed, with the longest light curves and spectra among them."""
        rng = np.random.default_rng(self.sample_seed)
        alerts = self.order[np.arange(self.served) % len(self.order)]
        picks = list(rng.choice(self.served, size=min(CHECKED, self.served), replace=False))
        for key in (self.points, self.spec_points):
            longest = np.flatnonzero(key[alerts] == key[alerts].max())[:4]
            picks += [int(i) for i in longest]
        return sorted(set(picks))

    def check(self, lower=None) -> dict:
        """Each compared alert's gap: the largest difference between two sets
        of class log-probabilities, each centred on its mean over the classes.
        Alerts whose routing is a near tie in the reference (second and third
        expert gates under ``TIE`` apart) are left out, since a rounding sends
        them to other experts. ``logit_gap_max_rel``, the number held: the
        largest gap of the served answers from the float32 reference, over
        the largest that the reference's own products rounded to bfloat16
        give at the same alerts, so that how sensitive the seed's weights are
        cancels. Also read: ``logit_gap``, the largest gap itself;
        ``logit_gap_all``, near ties included; ``logit_gap_p90_rel``, the
        90th percentiles' ratio. ``lower(picks)``, if given, gives the
        answers in the program's place (the control)."""
        picks = self.picks()
        want, margin = self.reference(picks, "f32")
        rounded, _ = self.reference(picks, "bf16")
        got = (lower(picks) if lower is not None
               else np.log(np.maximum(self.probs[picks].astype(np.float64), 1e-300)))
        gap, base = centred_gap(got, want), centred_gap(rounded, want)
        clear = margin >= TIE if (margin >= TIE).any() else np.ones_like(margin, bool)
        self.detail = {"gap": gap.tolist(), "base": base.tolist(), "margin": margin.tolist()}
        g, b = gap[clear], base[clear]
        return {"logit_gap_max_rel": float(g.max()) / max(float(b.max()), 1e-12),
                "logit_gap": float(g.max()), "logit_gap_all": float(gap.max()),
                "logit_gap_p90_rel": float(np.percentile(g, 90))
                / max(float(np.percentile(b, 90)), 1e-12)}


def centred_gap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per row, the largest |a - b| with each row centred on its mean."""
    return np.abs((a - a.mean(1, keepdims=True)) - (b - b.mean(1, keepdims=True))).max(axis=1)
