"""A checkout in miniature for the benchmark's CPU tests: the real
``BENCHMARK.json`` entries and metric readers, with configurations and
traffic cut to sizes a CPU test holds, float32 compute, and tight limits."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

BANKS = [[3, 5, 9], [3, 5, 7], [3, 3, 5], [3, 3, 3], [3, 3, 3]]
MODEL = {
    "BaselineCLS": {"d_model": 16, "n_heads": 2, "n_layers": 1, "dropout": 0.4, "max_len": 257},
    "SpectraNet": {"depths": [1, 1, 1, 1, 1], "channels": [4, 4, 4, 4, 4],
                   "kernel_sizes_per_stage": BANKS, "class_order": 9, "lr": 1e-4,
                   "weight_decay": 1e-2, "head_dropout": 0.5, "redshift": False},
    "AstroMiNN": {"num_mlp_experts": 4, "towers_hidden_dims": 4, "towers_outdims": 4,
                  "fusion_hidden_dims": 8, "fusion_outdims": 4, "moe_output_dims": 5,
                  "backbone_depths": [1, 1, 1, 1], "backbone_dims": [8, 8, 8, 8]},
    "AppleCider": {"num_classes": 5, "fusion": "avg", "hidden_dim": 5, "lr": 1e-4,
                   "grad_clip": 1.0, "criterion": "ce"},
}
# float32 on both sides: the gaps are rounding's, and the relative numbers
# (over bfloat16 rounding's gaps) far under 1
LIMITS = {"logit_gap": 1e-3, "logit_gap_all": 1e-3, "logit_gap_max_rel": 0.05,
          "logit_gap_p90_rel": 0.05, "loss_gap": 1e-4, "loss_gap_first": 1e-4,
          "grad_gap": 1e-3, "update_gap": 1e-3,
          "grad_gap_median": 1e-3, "update_gap_median": 1e-3, "grad_gap_rel": 0.05,
          "update_gap_rel": 0.05}
# cells that BENCHMARK.json does not hold yet, with their traffic and the
# numbers their check holds: the fused training step, whose reference
# replays the program's dropout draws, runs here
LATER = [({"name": "fusion-train-b256", "config": "applecider_fusion", "traffic": "fusion-b256",
           "chips": 1, "why": "fused retraining, every sample with a spectrum, dropout live"},
          {"kind": "train_steps", "samples_of": "fusion", "batch": 8, "samples": 1024,
           "length": [8, 257], "bins": 3481, "classes": 5, "mean": [2.0, 1.0, 3.0, -1.0],
           "std": [1.5, 1.0, 1.0, 0.5]},
          ("loss_gap", "grad_gap_rel", "update_gap_rel"))]


def make_root(tmp: Path) -> Path:
    """A checkout under ``tmp`` whose cells run on the CPU in seconds."""
    bench = spec.load_benchmark()
    (tmp / "benchmark").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic", "limits"):
        (tmp / "benchmark" / sub).mkdir(exist_ok=True)
    for conf in bench["configs"]:
        cfg = spec.read_json(spec.ROOT / conf["file"])
        cfg["model"] = {"name": cfg["model"]["name"],
                        **{k: MODEL[k] for k in cfg["model"] if k in MODEL}}
        cfg["train"]["compute_dtype"] = "float32"
        if "serve" in cfg:
            cfg["serve"]["batch_size"] = 32
        (tmp / conf["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        t = spec.read_json(spec.HERE / "traffic" / f"{w['traffic']}.json")
        if t["kind"] == "alert_stream":
            t["pool"] = 96
        else:
            t.update(batch=8, samples=1024)
        (tmp / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        limits = {k: LIMITS[k] for k in spec.limits(w["name"])}
        (tmp / "benchmark" / "limits" / f"{w['name']}.json").write_text(json.dumps(limits))
    for w, t, held in LATER:
        bench["workloads"].append(w)
        (tmp / "benchmark" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
        (tmp / "benchmark" / "limits" / f"{w['name']}.json").write_text(
            json.dumps({k: LIMITS[k] for k in held}))
    shutil.copytree(spec.HERE / "metrics", tmp / "benchmark" / "metrics", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
