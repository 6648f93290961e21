"""``BENCHMARK.json`` against the benchmark's rules, every part of every
cell found by name, and a cell added by new files and entries alone."""

from __future__ import annotations

import json
import re
import statistics

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_names_units_and_entry_keys():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[k]}) == len(BENCH[k])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for w in BENCH["workloads"]:
        cell = spec.find_cell(BENCH, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        # a per-layer metric moves an end-to-end metric its cell reports
        assert all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(w):
    cell = spec.find_cell(BENCH, w)
    assert cell.kind in ("alert_stream", "train_steps")
    spec.runner(cell.kind)
    ref = spec.reference(cell.config["name"])
    assert callable(ref.build) and callable(ref.forward_flops)
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
    checks = {"alert_stream": {"logit_gap", "logit_gap_all", "logit_gap_max_rel",
                               "logit_gap_p90_rel"},
              "train_steps": {"loss_gap", "loss_gap_first", "grad_gap", "update_gap",
                              "grad_gap_median", "update_gap_median", "grad_gap_rel",
                              "update_gap_rel"}}
    assert spec.limits(w) and set(spec.limits(w)) <= checks[cell.kind]


def test_configs_hold_the_published_widths():
    """Nothing is cut: every width of the program's defaults is in the
    configuration as run, and ``reduced`` is empty."""
    import tomllib

    from benchmark.harness.spec import ROOT

    with open(ROOT / "applecider_tpu_torch" / "default_config.toml", "rb") as f:
        defaults = tomllib.load(f)["model"]
    for c in BENCH["configs"]:
        cfg = spec.read_json(ROOT / c["file"])
        assert c["reduced"] == cfg["reduced"] == []
        for section, values in cfg["model"].items():
            if section != "name":
                assert values == defaults[section], section


def test_stratified_sizes_are_the_same_multiset_for_every_seed():
    from benchmark.harness import traffic

    p = dict(spec.read_json(spec.HERE / "traffic" / "alerts-spec30.json"), pool=200)
    a, b = traffic.alert_pool(p, 1), traffic.alert_pool(p, 2)
    for key in ("photo_t", "spec_wl"):
        assert sorted(len(x.get(key, ())) for x in a) == sorted(len(x.get(key, ())) for x in b)
    assert sum("spec_wl" in x for x in a) == 60
    assert [len(x["photo_t"]) for x in a] != [len(x["photo_t"]) for x in b]
    assert statistics.mean(len(x["photo_t"]) for x in a) == pytest.approx(138.5, abs=1)


def test_a_cell_traffic_and_metric_added_by_files_alone(tmp_path):
    """A new mix, a new cell, a new per-layer metric and an end-to-end
    metric of its own (``<quantity>.<suffix>``, with a bound of its own) are
    new files plus new entries: the harness runs the cell (on the CPU, at a
    tiny size) and reports the metrics without an edit to any file it has."""
    import time

    from benchmark.harness.execute import execute
    from benchmark.tests.tiny import make_root

    root = make_root(tmp_path)
    bench = spec.load_benchmark(root)
    t = spec.read_json(root / "benchmark" / "traffic" / "alerts-spec30.json")
    (root / "benchmark" / "traffic" / "alerts-spec50.json").write_text(
        json.dumps(dict(t, spectrum_frac=0.5)))
    (root / "benchmark" / "limits" / "fusion-serve-spec50.json").write_text(
        (root / "benchmark" / "limits" / "fusion-serve-spec30.json").read_text())
    (root / "benchmark" / "metrics" / "batches.serve.py").write_text(
        "def read(reading):\n    return float(reading.window['batches'])\n")
    bench["workloads"].append({"name": "fusion-serve-spec50", "config": "applecider_fusion",
                               "traffic": "alerts-spec50", "chips": 1, "why": "half carry spectra"})
    bench["per_layer"].append({"name": "batches.serve", "unit": "batches", "better": "lower",
                               "source": "program_counter", "layer": "feeder",
                               "moves": "alerts_per_s", "workloads": ["fusion-serve-spec50"]})
    bench["end_to_end"].append({"name": "alerts_per_s.spec50", "unit": "alerts/s",
                                "better": "higher", "bound": 0.1, "source": "host_clock",
                                "workloads": ["fusion-serve-spec50"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = execute("fusion-serve-spec50", 7, 0.5, True, time.perf_counter(), device="cpu", root=root)
    assert r["correct"] and r["metrics"]["batches.serve"]["value"] >= 1
    r = execute("fusion-serve-spec50", 7, 0.5, False, time.perf_counter(), device="cpu", root=root)
    assert set(r["metrics"]) == {"setup_s", "alerts_per_s.spec50"}
    assert r["metrics"]["alerts_per_s.spec50"]["value"] > 0
