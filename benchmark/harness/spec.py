"""Everything a cell is made of, found by name from ``BENCHMARK.json``.

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration is ``configs/<name>.json`` (its sizes, as the program's
  configuration tables) with its plain reference ``reference/<name>.py``;
* a traffic mix is ``traffic/<name>.json``, parameters that the generator of
  its ``kind`` (``harness/traffic.py``) reads and the runner of that kind
  (``harness/<kind>.py``) serves or trains on;
* a per-layer metric is ``metrics/<name>.py``, a reader of spans, counters
  and the trace;
* the limits of a cell's correctness check are ``limits/<cell>.json``.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # benchmark/
ROOT = HERE.parent                           # the checkout


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    chips: int = 1

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(root / conf["file"])
    config["name"] = conf["name"]
    traffic = read_json(root / "benchmark" / "traffic" / f"{entry['traffic']}.json")
    return Cell(name=name, config=config, traffic=traffic, chips=int(entry["chips"]),
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def reference(config_name: str):
    """The plain reference module of a configuration."""
    return importlib.import_module(f"benchmark.reference.{config_name}")


def metric_reader(name: str, root: Path = HERE):
    """``metrics/<name>.py`` loaded as a module (names hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def limits(cell: str, root: Path = ROOT) -> dict:
    return read_json(root / "benchmark" / "limits" / f"{cell}.json")


def runner(kind: str):
    return importlib.import_module(f"benchmark.harness.{kind}")
