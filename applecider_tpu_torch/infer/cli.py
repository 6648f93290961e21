"""``applecider-serve-torch``: classify every alert of a raw-data directory
with the port (counterpart of ``applecider_tpu/infer/cli.py``).

Weights come from the most recently trained run under ``--workdir``; the
run's config gives the model, the serving options and the stats.

    applecider-serve-torch --config run.toml --raw_path /data/ztf_objects
    applecider-serve-torch --config run.toml --warmup
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None, help="run TOML (defaults applied otherwise)")
    ap.add_argument("--raw_path", default=None,
                    help="raw L1 data dir (<obj>/{photometry.csv,alerts.npy,spectra.csv}); "
                         "falls back to [serve].data_location")
    ap.add_argument("--workdir", default=None, help="results root (trained runs live here)")
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--no-binned", action="store_true",
                    help="arrival-order batches instead of length-binned feeding")
    ap.add_argument("--warmup", action="store_true",
                    help="build the kernels and run every configured serving shape once, "
                         "then exit")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from applecider_tpu_torch.train.runtime import AppleCiderRuntime

    rt = AppleCiderRuntime(config_file=args.config, workdir=args.workdir, device=args.device)
    if args.batch_size is not None:
        rt.set_config("serve.batch_size", args.batch_size)
    if args.no_binned:
        rt.set_config("serve.binned", False)
    if args.warmup:
        print(json.dumps(rt.warmup()))
        return 0
    summary = rt.serve(raw_path=args.raw_path)
    print(json.dumps({
        "n_alerts": summary["n_alerts"],
        "alerts_per_sec": round(summary["alerts_per_sec"], 1),
        "run_dir": str(summary["run_dir"]),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
