"""Readings that set the limits of a cell's correctness check: the program's
numbers on many seeds, its control's (a lower precision in its place) and
those of planted faults, in one process so that set-up is paid once.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 8 \
        [--control [fp8|int8]] [--fault <name>]

Prints one JSON line a seed: {"workload", "seed", "mode", "checks"}. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", nargs="?", const="fp8", default=None,
                    help="a lower precision in the program's place: fp8 (the reference's), int8")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--dump", default=None,
                    help="a JSON-lines file for each seed's per-alert or per-leaf detail")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import faults, spec
    from benchmark.harness.execute import require_cards

    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    require_cards(cell.chips)
    fault = faults.FAULTS[cell.kind][args.fault] if args.fault else None
    mode = f"control-{args.control}" if args.control else (args.fault or "program")
    drv = spec.runner(cell.kind).Runner(cell, "cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        drv.prepare(seed, fault=fault)
        if args.control:
            checks = drv.control(args.seconds, args.control)
        else:
            if cell.kind == "alert_stream":
                drv.window(args.seconds)
            checks = drv.check()
        record = {"workload": args.workload, "seed": seed, "mode": mode, "checks": checks,
                  "seconds": time.perf_counter() - t0}
        print(json.dumps(record), flush=True)
        if args.dump:
            with open(args.dump, "a") as f:
                f.write(json.dumps(dict(record, detail=drv.detail)) + "\n")
    drv.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
