"""Production alert-stream serving quickstart of the PyTorch port on a
synthetic corpus.

The port's copy of ``serve_quickstart.py``: every alert of every object
classified causally (photometry cut at the alert's jd, the spectrum
attached only once taken) through the serving stack
(``FusedSpectraStream`` + ``LengthBinnedFeeder``), with
``applecider_tpu_torch`` alone. Runs on the GPU unless the CPU is asked
for:

    python docs/examples/torch_serve_quickstart.py /tmp/ac_serve [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(root: Path, device: str = "cuda") -> dict:
    import numpy as np
    import torch

    from applecider_tpu_torch.config import load_defaults
    from applecider_tpu_torch.infer.serve import iter_alert_samples, serve_alert_stream
    from applecider_tpu_torch.models import build_fusion_model
    from applecider_tpu_torch.testing import make_corpus

    root.mkdir(parents=True, exist_ok=True)
    data_dir, _ = make_corpus(root, n_objects=6, seed=11, n_photometry=30, n_alerts=6)

    # a trained checkpoint would come from AppleCiderRuntime.train(); here
    # random weights of a small config keep the example fast anywhere (use
    # load_defaults() unchanged for the published widths)
    cfg = load_defaults()
    for key, value in {"train.compute_dtype": "float32", "model.BaselineCLS.d_model": 16,
                       "model.BaselineCLS.n_heads": 2, "model.BaselineCLS.n_layers": 1,
                       "model.SpectraNet.channels": [4, 8], "model.SpectraNet.depths": [1, 1],
                       "model.SpectraNet.kernel_sizes_per_stage": [[3, 7], [3, 5]],
                       "model.AstroMiNN.backbone_depths": [1, 1],
                       "model.AstroMiNN.backbone_dims": [8, 16]}.items():
        cfg.set(key, value)
    grid = np.linspace(4500, 7980, 128, dtype=np.float32)
    model = build_fusion_model(cfg, device=device, generator=torch.Generator().manual_seed(0))

    out = root / "alerts.jsonl"
    summary = serve_alert_stream(model, iter_alert_samples(data_dir), batch_size=8,
                                 wave_grid=grid, out_jsonl=out, device=device)
    print(f"served {summary['n_alerts']} alerts ({summary['alerts_per_sec']:.1f} alerts/s) -> {out}")
    top = summary["results"][0]
    print("first alert:", top["object_id"], "jd", round(top["jd"], 3),
          "probs", np.round(top["probs"], 3).tolist())
    return summary


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(Path(args.root) if args.root else Path(tempfile.mkdtemp()), args.device)
