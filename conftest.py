"""Settings of a pytest run that belong to the process, not to one suite.

Under pytest-xdist each worker computes on its share of the cores, so that
``-n 6`` on 8 cores runs 6 compute threads and not 6 pools of 8. A run in
one process keeps every core. Each test under ``tests/`` gets
``TEST_LIMIT_S`` for its call: past it the test fails alone, with every
thread's stack on its stderr, and the rest of the suite runs on.

pytest loads conftests from the rootdir down, so this file runs before
``tests/conftest.py`` imports jax. XLA's own CPU pools are left alone.
"""

import faulthandler
import os
import signal
import sys
from pathlib import Path

import pytest

if "PYTEST_XDIST_WORKER" in os.environ:
    THREADS = max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    # before torch loads here, and inherited by the processes tests spawn
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(THREADS))

    import torch

    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)  # raises once torch has run parallel work

TESTS = Path(__file__).resolve().parent / "tests"
# about 3x the slowest call under `-n 6` on an 8-core host: 91.4, 100.4 and
# 106.5 s in three runs, tests/test_serve.py::test_serve_int8_close_to_f32
TEST_LIMIT_S = 300


def _over_limit(signum, frame):
    # fd 2, which the test's captured stderr holds
    faulthandler.dump_traceback(file=sys.__stderr__)
    pytest.fail(f"over its {TEST_LIMIT_S} s limit", pytrace=False)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if TESTS not in item.path.parents:
        yield
        return
    previous = signal.signal(signal.SIGALRM, _over_limit)
    signal.setitimer(signal.ITIMER_REAL, TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
