"""The port's schedules, experiment logger, multi-seed runner, seeds and
profiler scope (``train/optim.py``, ``utils/observability.py``,
``utils/rng.py``): the schedules equal the JAX package's optax schedules
at every step of their cycles to 1e-7, the rest by their contracts."""

import itertools
import json

import numpy as np
import pytest
import torch

from applecider_tpu.train import optim as jax_optim
from applecider_tpu.utils.observability import multi_seed_run as jax_multi_seed_run
from applecider_tpu_torch.train.optim import warmup_cosine, warmup_cosine_restarts
from applecider_tpu_torch.utils.observability import (
    ExperimentLogger, multi_seed_run, profile_trace,
)
from applecider_tpu_torch.utils.rng import key_iter, seed_everything


@pytest.mark.parametrize("args", [(3e-3, 5, 10, 3, 2, 0.05), (0.1, 0, 7, 2, 3, 0.0)])
def test_warmup_cosine_restarts_matches_optax(args):
    base_lr, warmup, first, n_cycles, t_mult, _ = args
    got, want = warmup_cosine_restarts(*args), jax_optim.warmup_cosine_restarts(*args)
    end = warmup + sum(first * t_mult ** i for i in range(n_cycles)) + 5  # into the floor
    for step in range(end):
        assert abs(got(step) - float(want(step))) <= 1e-7, step
    assert got(end) == pytest.approx(base_lr * max(args[5], 1e-3))


@pytest.mark.parametrize("args", [(1e-3, 10, 100), (0.1, 0, 40)])
def test_warmup_cosine_matches_optax(args):
    got, want = warmup_cosine(*args), jax_optim.warmup_cosine(*args)
    for step in range(args[2] + 5):
        assert abs(got(step) - float(want(step))) <= 1e-7, step


def test_experiment_logger_writes_jsonl(tmp_path):
    log = ExperimentLogger(tmp_path / "logs", wandb_project=None)
    log.log({"loss": torch.tensor(0.5), "acc": np.float32(0.25), "n": np.int64(3),
             "vec": torch.arange(3), "name": "a"}, step=7)
    log.log({"loss": 0.25})
    log.finish()
    lines = [json.loads(l) for l in (tmp_path / "logs" / "events.jsonl").read_text().splitlines()]
    assert lines == [{"loss": 0.5, "acc": 0.25, "n": 3, "vec": [0, 1, 2], "name": "a", "step": 7},
                     {"loss": 0.25}]


def test_multi_seed_run_matches_jax():
    def run(seed):
        out = {"acc": 0.5 + 0.1 * seed, "loss": np.float32(seed), "tag": "x"}
        if seed == 2:
            out["extra"] = 1.0
        return out

    got, want = multi_seed_run(run, [0, 1, 2]), jax_multi_seed_run(run, [0, 1, 2])
    assert got["summary"] == want["summary"]
    assert got["summary"]["acc"]["mean"] == pytest.approx(0.6)
    assert got["summary"]["extra"]["values"] == [1.0]


def test_key_iter_and_seed_everything():
    seeds = list(itertools.islice(key_iter(3), 4))
    assert seeds == list(itertools.islice(key_iter(3), 4))  # the same stream from the same seed
    assert len(set(seeds)) == 4 and all(0 <= s < 2**63 for s in seeds)
    assert seeds != list(itertools.islice(key_iter(4), 4))
    gens = list(itertools.islice(key_iter(3, "cpu"), 2))
    assert all(isinstance(g, torch.Generator) for g in gens)
    assert torch.equal(torch.rand(3, generator=gens[0]),
                       torch.rand(3, generator=torch.Generator().manual_seed(seeds[0])))
    rng = seed_everything(5)
    a, t = rng.random(), torch.rand(2)
    rng = seed_everything(5)
    assert rng.random() == a and torch.equal(torch.rand(2), t)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(tmp_path / "trace") as prof:
        torch.ones(8).mul(2).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mul" in e.get("name", "") for e in trace["traceEvents"])
    with profile_trace(tmp_path / "off", enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
