"""Padded rows over rows computed, in %, of the batches that
``infer.stream.pack_compact`` packs: the batch's rows (partial batches are
padded to the flush size) and the spectra block's rows (the block's zero
row and its rounding up to a spectra bucket)."""

SPANS = [("pack", "module:applecider_tpu_torch.infer.stream", "pack_compact")]


def note(args, kwargs, out):
    samples = args[0]
    real = len(samples) + sum(1 for s in samples if len(s.get("spec_wl", ())) >= 2)
    return {"rows": out["photo_t"].shape[0] + out["spec_wl"].shape[0], "real_rows": real}


def read(reading):
    calls = [c["note"] for c in reading.calls.get("pack", []) if "rows" in c["note"]]
    rows = sum(c["rows"] for c in calls)
    if not rows:
        return None
    return 100.0 * (1.0 - sum(c["real_rows"] for c in calls) / rows)
