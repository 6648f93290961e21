"""What the repo-root ``conftest.py`` does to a run: the time limit of each
test under ``tests/``, and the compute threads of an xdist worker and of a
run in one process. Each test runs pytest anew in a subprocess on a copy of
that conftest."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest_plugins = ["pytester"]

CONFTEST = (Path(__file__).resolve().parents[1] / "conftest.py").read_text()
LIMIT_LINE = "TEST_LIMIT_S = 300"


@pytest.fixture
def bare_env(monkeypatch):
    """The environment of a plain ``pytest`` call: no xdist worker's marks
    and no thread counts inherited from this run's own worker."""
    for var in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT",
                "OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)


def test_a_test_over_its_limit_fails_alone(pytester, bare_env):
    assert CONFTEST.count(LIMIT_LINE) == 1
    pytester.makeconftest(CONFTEST.replace(LIMIT_LINE, "TEST_LIMIT_S = 2"))
    pytester.makepyfile(**{"tests/test_hang": """
        import os
        import time

        def test_sleeps_past_the_limit():
            time.sleep(30)

        def test_blocks_in_a_c_call():
            read_end, _ = os.pipe()
            os.read(read_end, 1)  # nothing is ever written

        def test_next_in_the_file():
            assert True
    """, "elsewhere/test_free": """
        import time

        def test_outside_tests_has_no_limit():
            time.sleep(2.2)
    """})
    result = pytester.runpytest_subprocess(timeout=60)
    result.assert_outcomes(failed=2, passed=2)
    # each failure's report, with the dumped stacks of its test
    result.stdout.fnmatch_lines(["*_ test_sleeps_past_the_limit _*", "over its 2 s limit",
                                 "*line 5 in test_sleeps_past_the_limit",
                                 "*_ test_blocks_in_a_c_call _*", "over its 2 s limit",
                                 "*line 9 in test_blocks_in_a_c_call"])


def test_an_xdist_worker_computes_on_its_share_of_the_cores(pytester, bare_env):
    pytester.makeconftest(CONFTEST)
    pytester.makepyfile(test_threads="""
        import os

        import torch

        def test_threads():
            assert os.environ["PYTEST_XDIST_WORKER_COUNT"] == "2"
            assert torch.get_num_threads() == max(1, len(os.sched_getaffinity(0)) // 2)
    """)
    result = pytester.runpytest_subprocess("-p", "xdist", "-n", "2", timeout=120)
    result.assert_outcomes(passed=1)


def test_one_process_keeps_torch_default_threads(pytester, bare_env):
    # torch's own default in this environment, read beside the inner run
    ref = subprocess.Popen([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                           stdout=subprocess.PIPE, text=True)
    pytester.makeconftest(CONFTEST)
    pytester.makepyfile(test_threads="""
        import torch

        def test_threads():
            print(f"THREADS={torch.get_num_threads()}")
    """)
    result = pytester.runpytest_subprocess("-s", timeout=120)
    default = ref.communicate(timeout=120)[0].strip()
    result.assert_outcomes(passed=1)
    result.stdout.fnmatch_lines([f"*THREADS={default}*"])
