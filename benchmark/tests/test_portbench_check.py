"""The correctness check on the CPU at a tiny size: the program passes, and
each fault that a cell can have, planted under the timed path, and each
control (a lower precision in the program's place) reads as not correct.
These runs skip the harness's look for a card and drive the rest of a run."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import faults, spec
from benchmark.harness.execute import execute
from benchmark.tests.tiny import make_root

SERVE, TRAIN = "fusion-serve-spec30", "fusion-train-b256"
SEED = 2**31 + 11  # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return make_root(tmp_path_factory.mktemp("checkout"))


def run(root, cell, fault=None, traced=False):
    return execute(cell, SEED, 0.5, traced, time.perf_counter(), device="cpu", fault=fault,
                   root=root)


@pytest.mark.parametrize("cell", [SERVE, TRAIN, "spectranet-train-b256"])
def test_the_program_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and set(r["checks"]) == set(spec.limits(cell, root))
    assert set(r["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell,name", [(SERVE, n) for n in faults.SERVE]
                         + [(t, n) for t in (TRAIN, "spectranet-train-b256")
                            for n in faults.TRAIN])
def test_a_planted_fault_is_not_correct(root, cell, name):
    kind = spec.find_cell(spec.load_benchmark(root), cell, root).kind
    r = run(root, cell, faults.FAULTS[kind][name])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,control", [(SERVE, "fp8"), (SERVE, "int8"), (TRAIN, "fp8"),
                                          ("spectranet-train-b256", "fp8")])
def test_the_control_is_not_correct(root, cell, control):
    c = spec.find_cell(spec.load_benchmark(root), cell, root)
    drv = spec.runner(c.kind).Runner(c, "cpu")
    drv.prepare(SEED)
    readings = drv.control(0.5, control)
    drv.release()
    held = spec.limits(cell, root)
    assert any(readings[k] > limit for k, limit in held.items()), readings


def test_a_traced_run_reports_its_layers_and_checks(root):
    r = run(root, SERVE, traced=True)
    assert r["correct"] and "breakdown" in r
    # a run without a card reads no device time and writes no device metric
    assert r["device"]["busy_s"] == 0.0
    assert not {n for n in r["metrics"] if n.endswith(("_roofline.serve", "photometry_ms.serve"))}
    assert {"pack_ms.serve", "pad_share.serve", "mfu.serve"} <= set(r["metrics"])


def test_without_a_card_a_run_prints_no_result():
    """The measurement path finds no card and stops: exit code 2, nothing
    on standard output, no fall-back to the CPU."""
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(spec.HERE / "run.py"), "--workload", SERVE,
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert out.returncode == 2 and out.stdout == "" and "no result" in out.stderr


@pytest.mark.card
def test_a_tiny_cell_runs_on_the_card(card, root):
    """The traced path on the card reads device time (the tiny float32
    limits are the CPU's, so ``correct`` is not asserted here)."""
    r = execute("spectranet-train-b256", SEED, 0.5, True, time.perf_counter(), device="cuda",
                root=root)
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0 and r["checks"]
