"""The serving window's rate and tail: the rate over the whole window with
its drain, the 95th percentile over every alert handed off, and a stall that
moves both."""

from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark.harness import alert_stream


class FakeRouter:
    """The router's interface on the CPU: a batch's read-back takes
    ``service`` seconds, and ``stall`` more on the batch numbered
    ``stall_at``."""

    def __init__(self, service=0.002, stall=0.0, stall_at=3):
        import torch

        self.device = torch.device("cpu")
        self.service, self.stall, self.stall_at, self.n = service, stall, stall_at, 0

    def place(self, samples, length_buckets=None, pad_to=None):
        return len(samples)

    def run_placed(self, n):
        i, self.n = self.n, self.n + 1

        def resolve():
            time.sleep(self.service + (self.stall if i == self.stall_at else 0.0))
            return np.full((n, 5), 0.2, np.float32)

        return resolve


def make_runner(router, n=400):
    from applecider_tpu_torch.infer.stream import LengthBinnedFeeder

    d = object.__new__(alert_stream.Runner)
    rng = np.random.default_rng(0)
    d.router, d.batch, d.buckets = router, 16, (63, 127, 191, 255, 257)
    d.device = router.device
    d._feeder_cls = LengthBinnedFeeder
    d.model = type("M", (), {"num_classes": 5})()
    d.pool = [{"photo_t": np.zeros(int(k))} for k in rng.integers(20, 258, n)]
    d.order = rng.permutation(n)
    d.points = np.array([len(a["photo_t"]) for a in d.pool])
    d.spec_points = np.zeros(n, np.int64)
    d.ref = type("R", (), {"forward_flops": staticmethod(lambda cfg, p, s: 2.0 * p)})()
    d.cell = type("C", (), {"config": {}})()
    return d


def test_rate_is_over_the_whole_window_and_tail_over_every_alert():
    d = make_runner(FakeRouter())
    out = d.window(0.3)
    k = out["attempted"]
    assert out["failed"] == 0 and d.served == k and (d.probs == 0.2).all()
    # the drain is inside the window: the rate counts every alert over it
    assert out["e2e"]["alerts_per_s"] == pytest.approx(k / out["window_s"])
    assert out["window_s"] >= 0.3
    assert out["work"]["flops"] == pytest.approx(
        sum(2.0 * d.points[d.order[i % len(d.order)]] for i in range(k)))
    assert out["e2e"]["alert_p95_ms"] > 0


def test_a_stall_moves_the_rate_and_the_tail():
    steady = make_runner(FakeRouter()).window(0.4)
    stalled = make_runner(FakeRouter(stall=0.5)).window(0.4)
    assert stalled["e2e"]["alerts_per_s"] < 0.8 * steady["e2e"]["alerts_per_s"]
    assert stalled["e2e"]["alert_p95_ms"] > steady["e2e"]["alert_p95_ms"] + 100.0
