"""One run of one cell: set-up, the measured window (traced or not), the
result's metrics, the program's state freed, then the check against the
plain reference."""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from benchmark.harness import spec
from benchmark.harness.trace import Spans, profiled, reduce

# top-level module names that may not be loaded in a run: JAX, its
# libraries and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "applecider_tpu")


class RunError(RuntimeError):
    """A run that may print no result."""


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    found = forbidden_modules()
    if found:
        raise RunError(f"loaded in the run's process: {', '.join(found)}")


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise RunError("no CUDA device: the benchmark measures the program on the card")
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell needs {n} cards, {torch.cuda.device_count()} present")


class Reading:
    """What a per-layer reader reads: the spans' calls (``host_s``,
    ``device_s``, ``note``), the trace's ``busy_s`` and ``window_s``, and
    the window's outcome (``work``, ``loop``)."""

    def __init__(self, calls: dict, trace: dict, window: dict):
        self.calls, self.trace, self.window = calls, trace, window


def execute(workload: str, seed: int, seconds: float, traced: bool, started: float,
            device: str = "cuda", fault=None, root=spec.ROOT) -> dict:
    """The result of one run, as a dict whose ``checks`` come last.
    ``fault(runner)`` breaks the program under the run (the tests' faults);
    ``root`` is the checkout that holds ``BENCHMARK.json``."""
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload, root)
    if torch.device(device).type == "cuda":
        require_cards(cell.chips)
    readers = ({m["name"]: spec.metric_reader(m["name"], root / "benchmark")
                for m in cell.per_layer} if traced else {})
    drv = spec.runner(cell.kind).Runner(cell, device)
    drv.prepare(seed, fault=fault)
    spans = Spans()
    spans.install(readers.values(), drv.roots())
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = time.perf_counter() - started
    with profiled(traced, spans) as tr:
        out = drv.window(seconds, tick=tr.tick)
    spans.remove()
    refuse_forbidden()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    breakdown = None
    if traced:
        summary = reduce(tr.events, spans)
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        reading = Reading(spans.calls, summary, out)
        values = {name: r.read(reading) for name, r in readers.items()}
        metrics = {n: {"value": v, "unit": units[n]} for n, v in values.items()
                   if v is not None and math.isfinite(v)}
        breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        values = dict(out["e2e"], setup_s=setup_s)
        # a metric named <quantity>.<suffix> reports <quantity>: a later cell
        # may carry its own bound under a name of its own
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    drv.release()
    checks = drv.check()
    bounds = spec.limits(workload, root)
    compared = {k: {"value": checks[k], "limit": limit} for k, limit in bounds.items()}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    refuse_forbidden()  # the check's imports too
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compared
    return result


def emit(result: dict) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
