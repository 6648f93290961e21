"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's kernels built or loaded, weights and traffic made
from the seed, every shape of the cell warmed) is timed as ``setup_s``;
then the window runs for ``--seconds``, with the profiler on under
``--trace 1``. The last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and, last, ``checks``: each number compared
with the plain reference beside its limit, also the last lines on standard
error. A run without a card, or with fewer than the cell needs, or that
loaded JAX or the JAX package, exits with 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.execute import RunError, emit, execute

    try:
        result = execute(args.workload, args.seed, args.seconds, bool(args.trace), STARTED)
    except RunError as e:
        print(f"no result: {e}", file=sys.stderr, flush=True)
        return 2
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
