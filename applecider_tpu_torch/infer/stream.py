"""The alert-stream serving path: fixed-shape packed alert batches through
device preprocessing and the AppleCider forward to class probabilities.

Counterpart of ``applecider_tpu/infer/stream.py``. On each packed batch,
``AlertStreamPipeline`` runs, batched over the alerts:

* the greedy 12-hour per-band merge: group starts from kernel K1
  (``ops.merge_scan.seg_ids``), a weighted segment sum and a stable
  compaction by merged time;
* event featurisation (the model's (P, 7) layout plus the 10-column context
  block at the alert's cut);
* spectrum resampling onto the 3481-bin grid and mean/MAD normalisation;
* the AppleCider forward and a softmax.

That forward is one module, ``ServingProgram``, which ``torch.export``
traces whole (``train.runtime.export_serving``).

``FusedSpectraStream`` packs each batch with a compact spectra block (only
the spectra that exist, row 0 the zero spectrum), ``RoutedAlertStream``
splits it into the alerts with a spectrum and a ``skip_spectra`` pipeline
for the rest, and ``LengthBinnedFeeder`` groups alerts into batches by
light-curve length. Host packing
(``pack_alert_batch`` and friends) is NumPy and gives the JAX package's
arrays bit for bit.

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.ops.merge_scan import seg_ids, seg_ids_reference

LOG_CONST = float(1.0 / np.log(10.0))
N_BANDS = 3
DT_DAYS = 0.5  # the 12-hour merge window
EPS = 1e-8
_INF = float("inf")


# ---------------------------------------------------------------- merge
def merge_light_curve(t, flux, err, band, valid, seg):
    """Batched merge of (B, P) light curves in the packed layout (valid
    entries a time-ascending prefix), given the group-start ids ``seg``
    (B, P) of ``ops.merge_scan``.

    Returns (t_m, f_m, e_m, band_m, valid_m), each (B, P), sorted by merged
    time with invalid rows (time +inf as key, zeros as values) at the tail.
    Segment P collects the invalid slots and is dropped.
    """
    B, P = t.shape
    dev = t.device
    w = torch.where(valid, 1.0 / (err + EPS), 0.0)
    payload = torch.stack([w, valid.float(), w * t, w * flux, w * err], dim=-1)
    index = seg.long()[..., None].expand(B, P, 5)
    segs = torch.zeros((B, P + 1, 5), dtype=torch.float32, device=dev).scatter_add_(1, index, payload)
    wsum, cnt = segs[..., 0], segs[..., 1]
    safe = torch.clamp(wsum, min=EPS)
    t_m = segs[..., 2] / safe
    f_m = segs[..., 3] / safe
    e_m = segs[..., 4] / safe
    seg_valid = (cnt > 0) & (torch.arange(P + 1, device=dev) < P)
    # a segment's band is the band of its start point
    seg_band = torch.cat([band.int(), torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    key = torch.where(seg_valid, t_m, _INF)
    cols = torch.stack([t_m, f_m, e_m, seg_band.float(), seg_valid.float()], dim=-1)
    order = torch.argsort(key, dim=1, stable=True)[:, :P]
    picked = cols.gather(1, order[..., None].expand(B, P, 5))
    return (picked[..., 0], picked[..., 1], picked[..., 2],
            picked[..., 3].int(), picked[..., 4].bool())


# --------------------------------------------------------- featurization
def featurize_events(t_m, f_m, e_m, band_m, valid_m, horizon: Optional[float] = None):
    """Merged (B, P) light curves -> (B, P, 7) features, (B, P) pad mask,
    (B, 10) context block.

    Features: [log1p dt, log1p dt_prev, log10 flux, flux error in log10
    units, one-hot band(3)]. ``horizon`` (days) masks merged events more
    than that long after the first, as the training datasets drop them; the
    context block stays computed over every valid event.
    """
    t0 = torch.where(valid_m, t_m, _INF).amin(dim=1)
    t_safe = torch.where(valid_m, t_m, 0.0)
    keep = valid_m if horizon is None else valid_m & (t_m - t0[:, None] <= horizon)
    dt = torch.where(keep, t_m - t0[:, None], 0.0)
    prev_t = torch.cat([t0[:, None], t_safe[:, :-1]], dim=1)
    dt_prev = torch.where(keep, t_safe - prev_t, 0.0)
    f = torch.clamp(f_m, min=1e-6)
    logf = torch.where(keep, torch.log10(f), 0.0)
    logfe = torch.where(keep, e_m * LOG_CONST / f, 0.0)
    bands = torch.arange(N_BANDS, device=band_m.device)
    one_hot = (band_m[..., None] == bands).float() * keep[..., None]
    feats = torch.cat(
        [torch.stack([torch.log1p(dt), torch.log1p(dt_prev), logf, logfe], dim=-1), one_hot], dim=-1)

    # context at the cut (all valid events)
    mag = -2.5 * torch.log10(torch.clamp(f_m, min=1e-12))
    peak_i = torch.where(valid_m, f_m, -_INF).argmax(dim=1)  # first of ties
    t_peak = t_m.gather(1, peak_i[:, None])[:, 0]
    last_jd = torch.where(valid_m, t_m, -_INF).amax(dim=1)
    days_since = last_jd - t_peak
    days_to = t_peak - t0
    peakmag = torch.where(valid_m, mag, _INF).amin(dim=1)
    maxmag = torch.where(valid_m, mag, -_INF).amax(dim=1)
    ratio = torch.where(peakmag != 0, maxmag / peakmag, float("nan"))
    counts = ((band_m[..., None] == bands) & valid_m[..., None]).sum(dim=1).float()
    ctx = torch.cat([
        torch.stack([days_since, days_to, days_since + days_to, peakmag, maxmag, ratio], dim=1),
        counts.sum(dim=1, keepdim=True), counts,
    ], dim=1)
    ctx = torch.where(torch.isfinite(ctx), ctx, -999.0)
    return feats, ~keep, ctx


# -------------------------------------------------------------- spectra
def _median_exact(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis; the mean of the two central values when
    the length is even (``torch.median`` alone would return the lower)."""
    n = x.shape[-1]
    xs = torch.sort(x, dim=-1).values
    if n % 2:
        return xs[..., n // 2]
    return 0.5 * (xs[..., n // 2 - 1] + xs[..., n // 2])


def _mad_normalize(out: torch.Tensor) -> torch.Tensor:
    """(x - mean) / MAD per row (std, then 1, where the MAD is 0)."""
    mean = out.mean(dim=-1, keepdim=True)
    med = _median_exact(out)
    mad = _median_exact(torch.abs(out - med[..., None]))
    std = out.std(dim=-1, correction=0)
    scale = torch.where(mad > 0, mad, torch.where(std > 0, std, 1.0))
    return (out - mean) / scale[..., None]


def _uniform_grid(gnp: np.ndarray) -> bool:
    """True when every grid point sits within 0.45 bin of the ideal uniform
    lattice, so closed-form binning plus a +/-1 correction is exact."""
    G = gnp.shape[0]
    if G < 2:
        return False
    dg = (float(gnp[-1]) - float(gnp[0])) / (G - 1)
    ideal = float(gnp[0]) + np.arange(G) * dg
    return dg > 0 and float(np.max(np.abs(gnp - ideal))) <= 0.45 * dg


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.gather(1, idx[:, None])[:, 0]


class SpectrumGrid(nn.Module):
    """A wavelength grid held on a device (buffers ``values`` and, on a
    uniform grid, ``padded``), with linear interpolation (and boundary
    extrapolation) of packed spectra onto it plus MAD normalisation."""

    def __init__(self, grid, device):
        super().__init__()
        self.gnp = np.asarray(grid, np.float32)
        self.register_buffer("values", torch.from_numpy(self.gnp.copy()).to(device))
        self.uniform = _uniform_grid(self.gnp)
        if self.uniform:
            G = self.gnp.shape[0]
            self.g0 = float(self.gnp[0])
            self.inv_dg = float((G - 1) / (self.gnp[-1] - self.gnp[0]))
            inf = torch.full((1,), _INF, device=device)
            self.register_buffer("padded", torch.cat([-inf, self.values, inf]))  # (G + 2,)

    def resample(self, wl, flux, valid) -> torch.Tensor:
        """(R, S) spectra whose valid entries form an ascending-wavelength
        prefix (the packed layout) -> (R, G), normalised."""
        if not self.uniform:
            return _mad_normalize(self._reference(wl, flux, valid))
        x = torch.where(valid, wl, 1e30)
        y = torch.where(valid, flux, 0.0)
        return _mad_normalize(self._interp_fill(x, y, valid))

    def _interp_fill(self, x, y, valid):
        """Interpolation onto the uniform grid without a search: each
        sample's bin is closed-form arithmetic (corrected to searchsorted-
        right semantics by +/-1), the last sample of each bin is scattered
        for a forward "last valid" fill and the first for a backward
        "first valid" fill; the two fills give each grid point exactly the
        bracketing samples the searchsorted reference picks."""
        R, S = x.shape
        G = self.gnp.shape[0]
        dev = x.device
        grid, gridp = self.values, self.padded
        xc = torch.clamp(x, self.g0 - 1.0 / self.inv_dg, float(self.gnp[-1]) + 1.0 / self.inv_dg)
        b = torch.clamp(torch.floor((xc - self.g0) * self.inv_dg).int(), -1, G - 1)
        b = b + (gridp[(b + 2).long()] <= x).int()  # float-rounding correction, +/-1 at most
        b = b - ((gridp[(b + 1).long()] > x) & (b >= 0)).int()

        minus2 = torch.full((R, 1), -2, dtype=b.dtype, device=dev)
        no = torch.zeros((R, 1), dtype=torch.bool, device=dev)
        is_last = valid & ((b != torch.cat([b[:, 1:], minus2], 1)) | ~torch.cat([valid[:, 1:], no], 1))
        is_first = valid & ((b != torch.cat([minus2, b[:, :-1]], 1)) | ~torch.cat([no, valid[:, :-1]], 1))

        slots = (b + 1).long()  # [0, G]; unselected samples go to slot G + 1, dropped

        def scatter(sel):
            tgt = torch.where(sel, slots, G + 1)
            sx = torch.zeros((R, G + 2), dtype=x.dtype, device=dev).scatter_(1, tgt, x)[:, : G + 1]
            sy = torch.zeros((R, G + 2), dtype=y.dtype, device=dev).scatter_(1, tgt, y)[:, : G + 1]
            sh = torch.zeros((R, G + 2), dtype=torch.bool, device=dev).scatter_(1, tgt, sel)[:, : G + 1]
            return sx, sy, sh

        ar = torch.arange(G + 1, device=dev)
        sx, sy, sh = scatter(is_last)  # forward fill: slot g covers bins <= g - 1
        last = torch.where(sh, ar, -1).cummax(dim=1).values
        idx = last.clamp(min=0)
        x0, y0, h0 = sx.gather(1, idx)[:, :G], sy.gather(1, idx)[:, :G], (last >= 0)[:, :G]
        sx, sy, sh = scatter(is_first)  # backward fill: slot g + 1 covers bins >= g
        nxt = torch.where(sh, ar, G + 1).flip(1).cummin(dim=1).values.flip(1)
        idx = nxt.clamp(max=G)
        x1, y1, h1 = sx.gather(1, idx)[:, 1:], sy.gather(1, idx)[:, 1:], (nxt <= G)[:, 1:]

        slope = (y1 - y0) / torch.clamp(x1 - x0, min=1e-12)
        out = y0 + slope * (grid - x0)

        # boundary extrapolation from the first / last data segments
        n = torch.clamp(valid.sum(dim=1), min=2)
        xa, xb, ya, yb = x[:, 0:1], x[:, 1:2], y[:, 0:1], y[:, 1:2]
        s_left = (yb - ya) / torch.clamp(xb - xa, min=1e-12)
        out = torch.where(~h0, ya + s_left * (grid - xa), out)
        xl, xl1 = _gather_rows(x, n - 1)[:, None], _gather_rows(x, n - 2)[:, None]
        yl, yl1 = _gather_rows(y, n - 1)[:, None], _gather_rows(y, n - 2)[:, None]
        s_right = (yl - yl1) / torch.clamp(xl - xl1, min=1e-12)
        return torch.where(~h1, yl + s_right * (grid - xl), out)

    def _reference(self, wl, flux, valid):
        """Sort + searchsorted interpolation, for grids that are not uniform."""
        R = wl.shape[0]
        G = self.gnp.shape[0]
        grid = self.values
        wl_s = torch.where(valid, wl, 1e30)
        order = torch.argsort(wl_s, dim=1, stable=True)
        x, y = wl_s.gather(1, order), flux.gather(1, order)
        n = torch.clamp(valid.sum(dim=1), min=2)
        idx = torch.searchsorted(x.contiguous(), grid.expand(R, G).contiguous(), side="left")
        idx = torch.minimum(idx.clamp(min=1), (n - 1)[:, None])
        x0, x1 = x.gather(1, idx - 1), x.gather(1, idx)
        y0, y1 = y.gather(1, idx - 1), y.gather(1, idx)
        slope = (y1 - y0) / torch.clamp(x1 - x0, min=1e-12)
        out = y0 + slope * (grid - x0)
        s_left = (y[:, 1:2] - y[:, 0:1]) / torch.clamp(x[:, 1:2] - x[:, 0:1], min=1e-12)
        out = torch.where(grid < x[:, 0:1], y[:, 0:1] + s_left * (grid - x[:, 0:1]), out)
        xl, xl1 = _gather_rows(x, n - 1)[:, None], _gather_rows(x, n - 2)[:, None]
        yl, yl1 = _gather_rows(y, n - 1)[:, None], _gather_rows(y, n - 2)[:, None]
        s_right = (yl - yl1) / torch.clamp(xl - xl1, min=1e-12)
        return torch.where(grid > xl, yl + s_right * (grid - xl), out)


# ------------------------------------------------------------- pipeline
DEFAULT_GRID = np.linspace(4500.0, 7980.0, 3481, dtype=np.float32)


class ServingProgram(nn.Module):
    """The serving forward of one packed batch as one module: device
    preprocessing (``preprocess``), the AppleCider forward and the softmax.

    ``forward(raw)`` takes ``AlertStreamPipeline``'s raw dict and returns
    (B, num_classes) f32 probabilities. It holds the photometry statistics
    and the spectrum grid as buffers, records no ``inference_mode`` and
    branches only on shapes and on the options fixed at construction, so
    that ``torch.export`` traces it whole (``train.runtime.export_serving``)
    and the K1, K2 and K3f custom ops stay nodes of its graph.
    """

    def __init__(self, model, mean: torch.Tensor, std: torch.Tensor, grid: SpectrumGrid,
                 horizon_days: Optional[float], compact_spectra: bool, skip_spectra: bool,
                 kernels: bool):
        super().__init__()
        self.model = model
        self.grid = grid
        self.register_buffer("mean", mean)
        self.register_buffer("std", std)
        # metadata24 = meta19 + these context columns
        self.register_buffer("ctx_cols", torch.tensor([0, 1, 3, 4, 6], device=mean.device))
        self.horizon_days = horizon_days
        self.compact_spectra = compact_spectra
        self.skip_spectra = skip_spectra
        self.kernels = kernels

    def forward(self, raw: dict[str, torch.Tensor]) -> torch.Tensor:
        logits = self.model(**self.preprocess(raw), kernels=self.kernels)
        return torch.softmax(logits.float(), dim=-1)

    def preprocess(self, raw: dict) -> dict:
        """Device preprocessing of a placed batch: the model's inputs."""
        t, valid = raw["photo_t"], raw["photo_valid"]
        t_sorted = torch.where(valid, t, _INF)
        seg_fn = seg_ids if self.kernels else seg_ids_reference
        seg = seg_fn(t_sorted, raw["photo_band"], valid, DT_DAYS)
        merged = merge_light_curve(t, raw["photo_flux"], raw["photo_err"], raw["photo_band"],
                                   valid, seg)
        feats, pad_mask, ctx = featurize_events(*merged, horizon=self.horizon_days)
        cont = (feats[..., :4] - self.mean) / (self.std + 1e-8)
        photometry = torch.cat([cont, feats[..., 4:]], dim=-1)
        metadata = torch.cat([raw["meta19"], ctx.index_select(1, self.ctx_cols)], dim=1)

        if self.skip_spectra:
            spectra = torch.zeros((1, self.grid.gnp.shape[0]), device=t.device)
        else:
            spectra = self.grid.resample(raw["spec_wl"], raw["spec_flux"], raw["spec_valid"])
            has = raw["spec_has"] if self.compact_spectra else raw["has_spectrum"]
            spectra = torch.where(has[:, None], spectra, 0.0)
        return {
            "photometry": photometry, "photo_mask": pad_mask, "metadata": metadata,
            "images": raw["image"], "spectra": spectra,
            "spec_gather": raw["spec_gather"].long() if self.compact_spectra else None,
        }


class AlertStreamPipeline:
    """Preprocessing + AppleCider forward over fixed-shape packed batches.

    ``__call__(raw)`` with raw a dict of tensors on the pipeline's device:
      photo_t/photo_flux/photo_err (B, P) f32, photo_band (B, P) int32,
      photo_valid (B, P) bool, image (B, 63, 63, 3), meta19 (B, 19) and
      either spec_wl/spec_flux (B, S) f32, spec_valid (B, S) bool,
      has_spectrum (B,) bool, or with ``compact_spectra`` a compact
      (S+1, W) block with spec_has (S+1,) and spec_gather (B,) int32.
    Returns (B, num_classes) f32 probabilities, from ``program``, the
    ``ServingProgram`` that ``export_serving`` exports.

    ``kernels=False`` runs the plain PyTorch versions of the kernels on the
    same device: the yardstick the kernel path is held to.

    ``skip_spectra`` serves batches none of whose alerts has a spectrum:
    resampling and MAD are skipped, SpectraNet runs once on a (1, G) zero
    spectrum and its embedding broadcasts over the batch (every SpectraNet
    op is per sample, so this equals a batch of zero spectra). It excludes
    ``compact_spectra``.
    """

    def __init__(self, model, stats_mean=None, stats_std=None,
                 wave_grid: Optional[np.ndarray] = None, compact_spectra: bool = False,
                 horizon_days: Optional[float] = 100.0, device="cuda", kernels: bool = True,
                 skip_spectra: bool = False):
        if compact_spectra and skip_spectra:
            raise ValueError("compact_spectra and skip_spectra are mutually exclusive")
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev != self.device:
            raise ValueError(f"model is on {model_dev}, pipeline on {self.device}")
        self.model = model
        mean = torch.as_tensor(
            np.zeros(4, np.float32) if stats_mean is None else np.asarray(stats_mean, np.float32)
        ).to(self.device)
        std = torch.as_tensor(
            np.ones(4, np.float32) if stats_std is None else np.asarray(stats_std, np.float32)
        ).to(self.device)
        grid = SpectrumGrid(DEFAULT_GRID if wave_grid is None else wave_grid, self.device)
        self.program = ServingProgram(
            model, mean, std, grid, None if horizon_days is None else float(horizon_days),
            bool(compact_spectra), bool(skip_spectra), bool(kernels))

    @torch.inference_mode()
    def __call__(self, raw: dict) -> torch.Tensor:
        if raw["photo_t"].shape[0] == 0:
            return torch.zeros((0, self.model.num_classes), device=self.device)
        return self.program(raw)

    def preprocess(self, raw: dict) -> dict:
        """Device preprocessing of a placed batch: the model's inputs."""
        return self.program.preprocess(raw)


# ------------------------------------------------------- host packing
def decimate_spectrum(wl: np.ndarray, flux: np.ndarray, max_points: int):
    """Bin-average an overlong raw spectrum down to ``max_points`` equal-count
    segments over its full wavelength range (sorted first if needed);
    spectra that already fit pass through."""
    n = len(wl)
    if n <= max_points:
        return wl, flux
    wl = np.asarray(wl, np.float64)
    flux = np.asarray(flux, np.float64)
    if np.any(np.diff(wl) < 0):
        order = np.argsort(wl, kind="stable")
        wl, flux = wl[order], flux[order]
    edges = np.linspace(0, n, max_points + 1).astype(np.int64)
    counts = np.diff(edges)
    wl_d = np.add.reduceat(wl, edges[:-1]) / counts
    fx_d = np.add.reduceat(flux, edges[:-1]) / counts
    return wl_d.astype(np.float32), fx_d.astype(np.float32)


def _fitted_spectra(samples: list[dict], idx: list[int], W: int):
    """Per-sample (wl, flux) arrays fitted to width W (decimated if longer)."""
    return [decimate_spectrum(np.asarray(samples[i]["spec_wl"], np.float32),
                              np.asarray(samples[i]["spec_flux"], np.float32), W)
            for i in idx]


def _has_spectrum(s: dict) -> bool:
    wl = s.get("spec_wl")
    return wl is not None and len(wl) >= 2


def pack_alert_batch(samples: list[dict], max_photo: int = 257, max_spec: int = 512,
                     length_buckets: Optional[tuple[int, ...]] = None,
                     image_dtype=np.float32) -> dict:
    """Pack ragged per-alert dicts into fixed-shape NumPy arrays.

    Each sample: photo_t/photo_flux/photo_err/photo_band arrays, image
    (63, 63, 3), meta19 (19,), optional spec_wl/spec_flux. Light curves are
    time-sorted (kept as they are when already ascending) and truncated to
    their earliest ``max_photo`` points; ``length_buckets`` packs to the
    smallest bucket covering the longest curve. Spectra are fitted to
    ``max_spec`` points and wavelength-sorted.
    """
    B = len(samples)
    if length_buckets and samples:
        need = min(max(len(s["photo_t"]) for s in samples), max_photo)
        usable = [b for b in sorted(length_buckets) if b <= max_photo]
        max_photo = next((b for b in usable if b >= need), max_photo)
    img_shape = np.asarray(samples[0]["image"]).shape if samples else (63, 63, 3)
    out = {
        "photo_t": np.zeros((B, max_photo), np.float32),
        "photo_flux": np.zeros((B, max_photo), np.float32),
        "photo_err": np.ones((B, max_photo), np.float32),
        "photo_band": np.zeros((B, max_photo), np.int32),
        "photo_valid": np.zeros((B, max_photo), bool),
        "meta19": np.empty((B, 19), np.float32),
        "spec_wl": np.zeros((B, max_spec), np.float32),
        "spec_flux": np.zeros((B, max_spec), np.float32),
        "spec_valid": np.zeros((B, max_spec), bool),
        "has_spectrum": np.zeros((B,), bool),
    }
    if not samples:
        out["image"] = np.zeros((0, *img_shape), image_dtype)
        return out

    # photometry: flat concatenation, one lexsort, one scatter per column
    lens = np.fromiter((len(s["photo_t"]) for s in samples), np.int64, count=B)
    t_all = np.concatenate([np.asarray(s["photo_t"], np.float32) for s in samples])
    sid = np.repeat(np.arange(B, dtype=np.int64), lens)
    if t_all.shape[0] > 1:
        # skip the sort when every sample's times already ascend (NaN
        # compares False and takes the sort)
        asc = np.diff(t_all) >= 0
        bnd = np.cumsum(lens)[:-1] - 1  # comparisons across samples are exempt
        asc[bnd[(bnd >= 0) & (bnd < asc.shape[0])]] = True
        presorted = bool(asc.all())
    else:
        presorted = True
    order = None if presorted else np.lexsort((t_all, sid))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    col = np.arange(t_all.shape[0], dtype=np.int64) - np.repeat(starts, lens)
    keep = col < max_photo  # truncate overlong light curves (keep earliest)
    rows, cols = sid[keep], col[keep]
    src = np.flatnonzero(keep) if order is None else order[keep]
    out["photo_t"][rows, cols] = t_all[src]
    f_all = np.concatenate([np.asarray(s["photo_flux"], np.float32) for s in samples])
    e_all = np.concatenate([np.asarray(s["photo_err"], np.float32) for s in samples])
    b_all = np.concatenate([np.asarray(s["photo_band"], np.int32) for s in samples])
    out["photo_flux"][rows, cols] = f_all[src]
    out["photo_err"][rows, cols] = e_all[src]
    out["photo_band"][rows, cols] = b_all[src]
    out["photo_valid"][rows, cols] = True

    img = np.empty((B, *img_shape), image_dtype)
    for i, s in enumerate(samples):
        img[i] = s["image"]
    out["image"] = img
    out["meta19"] = np.stack([s["meta19"] for s in samples]).astype(np.float32, copy=False)

    spec_idx = [i for i, s in enumerate(samples) if _has_spectrum(s)]
    if spec_idx:
        fitted = _fitted_spectra(samples, spec_idx, max_spec)
        srows = np.repeat(np.asarray(spec_idx, np.int64), [len(w) for w, _ in fitted])
        _scatter_spectra(fitted, srows, out["spec_wl"], out["spec_flux"], out["spec_valid"])
        out["has_spectrum"][np.asarray(spec_idx)] = True
    return out


def _scatter_spectra(fitted, srows, wl, fx, vd) -> None:
    """Write fitted spectra into rows ``srows`` as ascending-wavelength
    prefixes (one stable lexsort of the concatenated stream)."""
    slens = np.fromiter((len(w) for w, _ in fitted), np.int64, count=len(fitted))
    wl_all = np.concatenate([w for w, _ in fitted])
    fx_all = np.concatenate([f for _, f in fitted])
    sstarts = np.concatenate([[0], np.cumsum(slens)[:-1]])
    scols = np.arange(wl_all.shape[0], dtype=np.int64) - np.repeat(sstarts, slens)
    sorder = np.lexsort((wl_all, srows))
    wl[srows, scols] = wl_all[sorder]
    fx[srows, scols] = fx_all[sorder]
    vd[srows, scols] = True


class RoutedAlertStream:
    """Spectrum-presence router over two pipelines: the alerts with a
    spectrum go through the full pipeline (resampling at ``max_spec`` 512,
    SpectraNet per alert), the others through the ``skip_spectra`` one
    (packed at ``max_spec`` 1, one zero-spectrum SpectraNet row broadcast).
    Every SpectraNet op is per sample, so the split equals one monolithic
    pass.

    Each sub-batch is packed from its real alerts and padded to the next of
    ``batch_buckets`` by tiling its first packed row; pad rows are sliced
    off and results come back in input order. ``run_placed`` enqueues both
    sub-batches before either is read back.
    """

    def __init__(self, model, batch_buckets=(8, 32, 64, 96, 128, 192, 256, 384, 512),
                 device="cuda", **pipeline_kw):
        self.full = AlertStreamPipeline(model, device=device, **pipeline_kw)
        self.nospec = AlertStreamPipeline(model, skip_spectra=True, device=device, **pipeline_kw)
        self.device = self.full.device
        self.batch_buckets = tuple(sorted(batch_buckets))

    def _bucket(self, n: int) -> int:
        return next((b for b in self.batch_buckets if b >= n), n)

    def place(self, samples: list[dict], length_buckets=None):
        """Split, pack and copy both sub-batches to the device without
        running them; the opaque result goes to ``run_placed``."""
        parts = []
        for with_spectrum, max_spec in ((True, 512), (False, 1)):
            idx = [i for i, s in enumerate(samples) if _has_spectrum(s) == with_spectrum]
            if not idx:
                parts.append((None, idx))
                continue
            raw = pack_alert_batch([samples[i] for i in idx], max_spec=max_spec,
                                   length_buckets=length_buckets)
            pad = self._bucket(len(idx)) - len(idx)
            if pad:  # pack the real alerts once, then tile the first row
                raw = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in raw.items()}
            parts.append(({k: torch.from_numpy(v).to(self.device) for k, v in raw.items()}, idx))
        return len(samples), parts

    def run_placed(self, placed):
        """Enqueue both sub-batches of a placed batch; returns a zero-argument
        resolver that waits for them and returns (N, C) NumPy probabilities
        in input order."""
        n, parts = placed
        outs = [None if raw is None else pipe(raw)
                for pipe, (raw, _) in zip((self.full, self.nospec), parts)]

        def resolve() -> np.ndarray:
            probs = np.zeros((n, self.full.model.num_classes), np.float32)
            for out, (_, idx) in zip(outs, parts):
                if out is not None:
                    probs[np.asarray(idx)] = out.cpu().numpy()[: len(idx)]
            return probs

        return resolve

    def __call__(self, samples: list[dict], length_buckets=None) -> np.ndarray:
        """Pack, place and run one batch; (N, C) NumPy probabilities."""
        return self.run_placed(self.place(samples, length_buckets=length_buckets))()


SPEC_POINTS = 512  # points a spectrum of the compact block is fitted to


def pack_compact(samples: list[dict], spec_buckets, length_buckets=None, pad_to=None) -> dict:
    """Host half of ``FusedSpectraStream.place``: pack the batch, the compact
    spectra block and the gather map into NumPy arrays. The block holds the
    batch's spectra after a zero row 0, their count rounded up to
    ``spec_buckets``. ``pad_to`` pads the packed batch rows with copies of
    row 0 (callers slice the pad off the output)."""
    raw = pack_alert_batch(samples, max_spec=1, length_buckets=length_buckets)
    for k in ("spec_wl", "spec_flux", "spec_valid", "has_spectrum"):
        del raw[k]
    B = len(samples)
    W = SPEC_POINTS
    spec_idx = [i for i, s in enumerate(samples) if _has_spectrum(s)]
    S = next((b for b in sorted(spec_buckets) if b >= len(spec_idx)), len(spec_idx))
    wl = np.zeros((S + 1, W), np.float32)
    fx = np.zeros((S + 1, W), np.float32)
    vd = np.zeros((S + 1, W), bool)
    has = np.zeros((S + 1,), bool)
    gather = np.zeros((B,), np.int32)
    if spec_idx:
        fitted = _fitted_spectra(samples, spec_idx, W)
        srows = np.repeat(1 + np.arange(len(spec_idx), dtype=np.int64),
                          [len(w) for w, _ in fitted])
        _scatter_spectra(fitted, srows, wl, fx, vd)
        has[1:len(spec_idx) + 1] = True
        gather[np.asarray(spec_idx)] = 1 + np.arange(len(spec_idx), dtype=np.int32)
    raw.update(spec_wl=wl, spec_flux=fx, spec_valid=vd, spec_has=has, spec_gather=gather)
    if pad_to is not None and B and pad_to > B:
        # batch-dim arrays only; the spectra block is batch-independent
        raw = {k: (np.concatenate([v, np.repeat(v[:1], pad_to - B, axis=0)])
                   if v.shape and v.shape[0] == B else v)
               for k, v in raw.items()}
    return raw


class FusedSpectraStream:
    """One forward per batch with a compact spectra block.

    The photometry, image and metadata encoders run on the full batch;
    resampling and SpectraNet run on an (S+1, W) block holding only the
    spectra that exist (row 0 the zero spectrum, S rounded up to
    ``spec_buckets``), and the spectra embeddings gather back to the batch.
    Every SpectraNet op is per sample, so this equals running the whole
    batch with zero spectra where there are none.
    """

    def __init__(self, model, spec_buckets=(0, 4, 8, 16, 32, 64, 96, 112, 128, 192, 256,
                                            320, 384, 512),
                 device="cuda", **pipeline_kw):
        self.pipe = AlertStreamPipeline(model, compact_spectra=True, device=device, **pipeline_kw)
        self.device = self.pipe.device
        self.spec_buckets = tuple(sorted(spec_buckets))

    def place(self, samples: list[dict], length_buckets=None, pad_to=None,
              host_only: bool = False):
        """``pack_compact`` with this stream's ``spec_buckets``; ``host_only``
        returns the NumPy dict, else it is copied to the device."""
        raw = pack_compact(samples, self.spec_buckets, length_buckets=length_buckets, pad_to=pad_to)
        return raw if host_only else self.place_packed(raw)

    def place_packed(self, raw: dict) -> dict:
        """Copy a ``place(..., host_only=True)`` dict to the device."""
        return {k: torch.from_numpy(v).to(self.device) for k, v in raw.items()}

    def run_placed(self, placed: dict):
        """Enqueue the forward of a placed batch; returns a zero-argument
        resolver that waits for it and returns (B, C) NumPy probabilities."""
        out = self.pipe(placed)
        return lambda: out.cpu().numpy()

    def __call__(self, samples: list[dict], length_buckets=None) -> np.ndarray:
        """Pack, place and run one batch; (B, C) NumPy probabilities."""
        return self.run_placed(self.place(samples, length_buckets=length_buckets))()


# light-curve lengths a batch is packed to (the longest is max_len 257)
LENGTH_BUCKETS = (63, 127, 191, 255, 257)


class LengthBinnedFeeder:
    """Batches alerts by light-curve length so that each batch runs at its
    own length bucket; outputs are those of the router, per alert.

    ``submit([(index, sample), ...])`` returns the ``(indices, resolver)``
    pairs of the queues that reached ``flush_bs``; ``flush()`` emits every
    partial queue, padded to ``flush_bs`` (the pad rows are sliced off).
    """

    def __init__(self, router: FusedSpectraStream, flush_bs: int = 1024,
                 length_buckets: tuple = LENGTH_BUCKETS, device="cuda"):
        dev = resolve_device(device)
        if router.device != dev:
            raise ValueError(f"router runs on {router.device}, feeder asked for {dev}")
        self.router = router
        self.flush_bs = int(flush_bs)
        self.length_buckets = tuple(sorted(length_buckets))
        self._queues: dict[int, list] = {b: [] for b in self.length_buckets}

    def _bucket_of(self, sample: dict) -> int:
        n = len(sample["photo_t"])
        return next((b for b in self.length_buckets if b >= n), self.length_buckets[-1])

    def _emit(self, bucket: int, pad: bool = False):
        entries = self._queues[bucket]
        self._queues[bucket] = []
        indices = [i for i, _ in entries]
        samples = [s for _, s in entries]
        n_real = len(samples)
        placed = self.router.place(samples, length_buckets=(bucket,),
                                   pad_to=self.flush_bs if pad and n_real < self.flush_bs else None)
        inner = self.router.run_placed(placed)
        return indices, lambda: inner()[:n_real]

    def submit(self, indexed_samples) -> list:
        """Enqueue ``(index, sample)`` pairs; returns the batches now ready."""
        ready = []
        for idx, s in indexed_samples:
            b = self._bucket_of(s)
            self._queues[b].append((idx, s))
            if len(self._queues[b]) >= self.flush_bs:
                ready.append(self._emit(b))
        return ready

    def flush(self) -> list:
        """Emit every non-empty partial queue (padded to ``flush_bs``)."""
        return [self._emit(b, pad=True) for b in self.length_buckets if self._queues[b]]
