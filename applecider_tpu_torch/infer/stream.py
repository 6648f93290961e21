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

With ``mesh=`` (``parallel.mesh.make_mesh``), the three streams run
data-parallel over the ranks of a process group: each rank runs its slice of
the packed batch's rows along the data axis (the compact spectra block, and
a batch whose rows do not divide, whole on every rank), and the
probabilities are gathered, so every rank returns every row in input order.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import ClassVar, Optional

import numpy as np
import torch
from torch import nn

from applecider_tpu_torch.device import resolve_device
from applecider_tpu_torch.ops import quant
from applecider_tpu_torch.ops.merge_scan import seg_ids, seg_ids_reference
from applecider_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_batch

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


def resample_spectrum(wl, flux, valid, grid, assume_sorted: bool = False) -> torch.Tensor:
    """One spectrum (S,) or a block (R, S) linearly interpolated onto
    ``grid`` (with boundary extrapolation), then MAD-normalised: the JAX
    package's ``resample_spectrum`` by name, over ``SpectrumGrid.resample``
    on ``wl``'s device. ``assume_sorted``: the valid entries already form an
    ascending-wavelength prefix (``pack_alert_batch``'s layout); otherwise
    they are sorted first."""
    one = wl.dim() == 1
    wl, flux, valid = (t[None] if one else t for t in (wl, flux, valid))
    if not assume_sorted:
        x = torch.where(valid, wl, 1e30)
        order = torch.argsort(x, dim=1, stable=True)
        wl, flux = x.gather(1, order), flux.gather(1, order)
        valid = wl < 1e29
    out = SpectrumGrid(grid, wl.device).resample(wl, flux, valid)
    return out[0] if one else out

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

    ``quantize_scales`` (from ``calibrate``) serves in int8: the layers
    with a scale are quantized once (``ops.quant.prepare``), and the
    forward runs inside ``ops.quant.quantized``, so each of them computes
    with the int8 kernels (their twins with ``kernels=False``).

    ``skip_spectra`` serves batches none of whose alerts has a spectrum:
    resampling and MAD are skipped, SpectraNet runs once on a (1, G) zero
    spectrum and its embedding broadcasts over the batch (every SpectraNet
    op is per sample, so this equals a batch of zero spectra). It excludes
    ``compact_spectra``.

    ``mesh``: each rank runs its data-axis rows of every batch (``shard``)
    and the probabilities are gathered over the data axis; the compact
    spectra block and ``spec_has`` stay whole (every rank's ``spec_gather``
    indexes the full block), as does a batch whose rows do not divide.
    """

    _COMPACT_REPLICATED = ("spec_wl", "spec_flux", "spec_valid", "spec_has")

    def __init__(self, model, stats_mean=None, stats_std=None,
                 wave_grid: Optional[np.ndarray] = None, compact_spectra: bool = False,
                 horizon_days: Optional[float] = 100.0, device="cuda", kernels: bool = True,
                 skip_spectra: bool = False, quantize_scales: Optional[dict] = None,
                 mesh: Mesh | None = None):
        if compact_spectra and skip_spectra:
            raise ValueError("compact_spectra and skip_spectra are mutually exclusive")
        self.mesh = mesh
        self.device = resolve_device(device)
        model_dev = next(model.parameters()).device
        if model_dev != self.device:
            raise ValueError(f"model is on {model_dev}, pipeline on {self.device}")
        self.model = quant.set_paths(model)
        self.quant_scales = dict(quantize_scales) if quantize_scales else None
        # the layers quantized once, for every forward
        self.quant_layers = quant.prepare(model, self.quant_scales) if self.quant_scales else None
        self.kernels = bool(kernels)
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

    def shard(self, raw: dict) -> "ShardedRaw":
        """This rank's rows of a packed batch (NumPy or tensors) under the
        mesh; a batch already sharded passes through."""
        if isinstance(raw, ShardedRaw):
            return raw
        n = self.mesh.shape["data"]
        B = raw["photo_t"].shape[0]
        if B == 0 or B % n:
            return ShardedRaw(raw, sharded=False)
        whole = self._COMPACT_REPLICATED if self.program.compact_spectra else ()
        return ShardedRaw({k: v if k in whole else shard_batch(v, self.mesh)
                           for k, v in raw.items()}, sharded=True)

    @torch.inference_mode()
    def __call__(self, raw: dict) -> torch.Tensor:
        if self.mesh is None:
            return self._run(raw)
        raw = self.shard(raw)
        probs = self._run(raw)
        return gather_rows(probs, self.mesh) if raw.sharded else probs

    def _run(self, raw: dict) -> torch.Tensor:
        if raw["photo_t"].shape[0] == 0:
            return torch.zeros((0, self.model.num_classes), device=self.device)
        if self.quant_scales is not None:
            with quant.quantized(self.quant_scales, kernels=self.kernels,
                                 layers=self.quant_layers):
                return self.program(raw)
        return self.program(raw)

    @torch.inference_mode()
    def calibrate(self, raws: list, percentile_headroom: float = 1.0) -> dict:
        """Observe each layer's input range on representative placed
        batches, the float forward run eagerly on the model's device;
        returns the {module path: scale} dict that ``quantize_scales``
        takes."""
        return quant.calibrate(self.program, raws, percentile_headroom=percentile_headroom)

    def preprocess(self, raw: dict) -> dict:
        """Device preprocessing of a placed batch: the model's inputs."""
        return self.program.preprocess(raw)


class ShardedRaw(dict):
    """A packed batch as ``AlertStreamPipeline.shard`` leaves it: this
    rank's rows (``sharded``), or every row on every rank."""

    def __init__(self, items, sharded: bool):
        super().__init__(items)
        self.sharded = sharded

    def to(self, device) -> "ShardedRaw":
        """Every array copied to ``device`` as a tensor."""
        return ShardedRaw({k: torch.as_tensor(v).to(device) for k, v in self.items()},
                          self.sharded)


# ------------------------------------------------------- host packing
@dataclasses.dataclass
class PackCounts:
    """How often each path of the host pack ran in this process, cumulative
    (a worker process keeps its own): ``batches`` packed, ``photo_sorted``
    batches whose light curves took the lexsort, ``spectra`` packed,
    ``spectra_sorted`` overlong spectra sorted by wavelength before
    decimation, ``spectra_decimated`` spectra longer than the packed width,
    ``scatter_sorted`` spectra blocks whose fitted spectra took the lexsort."""

    batches: int = 0
    photo_sorted: int = 0
    spectra: int = 0
    spectra_sorted: int = 0
    spectra_decimated: int = 0
    scatter_sorted: int = 0
    _lock: ClassVar[threading.Lock] = threading.Lock()

    def add(self, **counts: int) -> None:
        with self._lock:  # threads may pack at once
            for name, n in counts.items():
                setattr(self, name, getattr(self, name) + n)

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name, 0)


PACK_COUNTS = PackCounts()


def decimate_spectrum(wl: np.ndarray, flux: np.ndarray, max_points: int):
    """Bin-average an overlong raw spectrum down to ``max_points`` equal-count
    segments over its full wavelength range (sorted first if needed);
    spectra that already fit pass through."""
    n = len(wl)
    if n <= max_points:
        return wl, flux
    wl_d, fx_d, _ = _decimate(np.asarray(wl, np.float64), np.asarray(flux, np.float64),
                              np.array([n], np.int64), max_points)
    return wl_d[0], fx_d[0]


def _starts(lens: np.ndarray) -> np.ndarray:
    """Offsets of consecutive segments of ``lens`` in their concatenation."""
    starts = np.zeros_like(lens)
    np.cumsum(lens[:-1], out=starts[1:])
    return starts


def _concat(arrays, dtype) -> np.ndarray:
    """One array of ``arrays`` end to end, each cast to ``dtype`` as
    ``np.asarray(a, dtype)`` casts it."""
    return np.concatenate(arrays, dtype=dtype, casting="unsafe")


def _decimate(wl: np.ndarray, fx: np.ndarray, lens: np.ndarray, W: int):
    """Bin-average spectra longer than ``W``, given end to end as float64
    ``wl`` and ``fx`` with lengths ``lens``, each to ``W`` equal-count
    segments over its full wavelength range, all in one ``reduceat``. A
    spectrum with a descending step is stably sorted by wavelength first
    (NaN compares False). Returns float32 (len(lens), W) wavelengths and
    fluxes, and how many spectra were sorted. The inputs are not changed."""
    starts = _starts(lens)
    desc = wl[1:] < wl[:-1]
    desc[starts[1:] - 1] = False  # steps from one spectrum to the next
    sorted_ = np.unique(np.searchsorted(starts, np.flatnonzero(desc), side="right") - 1)
    if len(sorted_):
        wl, fx = wl.copy(), fx.copy()
        for k in sorted_:
            seg = slice(starts[k], starts[k] + lens[k])
            order = np.argsort(wl[seg], kind="stable")
            wl[seg], fx[seg] = wl[seg][order], fx[seg][order]
    # np.linspace(0, n, W + 1).astype(np.int64) for every spectrum at once
    edges = np.arange(W + 1, dtype=np.float64) * (lens / W)[:, None]
    edges[:, -1] = lens
    edges = edges.astype(np.int64)
    at = (edges[:, :-1] + starts[:, None]).ravel()
    counts = np.diff(edges, axis=1).ravel()
    wl_d = (np.add.reduceat(wl, at) / counts).astype(np.float32).reshape(-1, W)
    fx_d = (np.add.reduceat(fx, at) / counts).astype(np.float32).reshape(-1, W)
    return wl_d, fx_d, len(sorted_)


def _fit_spectra(samples: list[dict], idx: list[int], W: int):
    """The spectra of ``samples[idx]`` fitted to ``W`` points, concatenated in
    order: (fitted lengths, float32 wavelengths, float32 fluxes). What fits
    passes through; every longer spectrum is ``decimate_spectrum``'s, all in
    one ``_decimate`` call."""
    wl = [samples[i]["spec_wl"] for i in idx]
    fx = [samples[i]["spec_flux"] for i in idx]
    n = np.fromiter(map(len, wl), np.int64, count=len(idx))
    over = n > W
    PACK_COUNTS.add(spectra=len(idx), spectra_decimated=int(over.sum()))
    if not over.any():
        return n, _concat(wl, np.float32), _concat(fx, np.float32)
    owl = _concat([w for w, o in zip(wl, over) if o], np.float32).astype(np.float64)
    ofx = _concat([f for f, o in zip(fx, over) if o], np.float32).astype(np.float64)
    dwl, dfx, n_sorted = _decimate(owl, ofx, n[over], W)
    PACK_COUNTS.add(spectra_sorted=n_sorted)
    dec = iter(zip(dwl, dfx))
    fitted = [next(dec) if o else (w, f) for w, f, o in zip(wl, fx, over)]
    return (np.minimum(n, W), _concat([w for w, _ in fitted], np.float32),
            _concat([f for _, f in fitted], np.float32))


def _pack_spectra(samples: list[dict], idx: list[int], rows: np.ndarray,
                  wl: np.ndarray, fx: np.ndarray, vd: np.ndarray) -> None:
    """Fit the spectra of ``samples[idx]`` to the width of ``wl`` and write
    them into its ascending ``rows`` as ascending-wavelength prefixes. The
    stable lexsort that orders them runs only when a fitted spectrum does
    not ascend (NaN does not)."""
    fit, wl_fit, fx_fit = _fit_spectra(samples, idx, wl.shape[1])
    asc = wl_fit[1:] >= wl_fit[:-1]
    asc[np.cumsum(fit)[:-1] - 1] = True  # steps from one spectrum to the next
    if not asc.all():
        PACK_COUNTS.add(scatter_sorted=1)
        order = np.lexsort((wl_fit, np.repeat(rows, fit)))
        wl_fit, fx_fit = wl_fit[order], fx_fit[order]
    vd[rows] = np.arange(wl.shape[1]) < fit[:, None]
    wl[vd] = wl_fit
    fx[vd] = fx_fit


def _has_spectrum(s: dict) -> bool:
    wl = s.get("spec_wl")
    return wl is not None and len(wl) >= 2


_PHOTO_COLUMNS = (("photo_t", np.float32, 0), ("photo_flux", np.float32, 0),
                  ("photo_err", np.float32, 1), ("photo_band", np.int32, 0))


def _pack_rows(samples: list[dict], max_photo: int, length_buckets, image_dtype) -> dict:
    """``pack_alert_batch``'s photometry, ``meta19`` and ``image`` arrays."""
    PACK_COUNTS.add(batches=1)
    B = len(samples)
    if length_buckets and samples:
        need = min(max(len(s["photo_t"]) for s in samples), max_photo)
        usable = [b for b in sorted(length_buckets) if b <= max_photo]
        max_photo = next((b for b in usable if b >= need), max_photo)
    P = max_photo
    out = {k: np.full((B, P), fill, dtype) for k, dtype, fill in _PHOTO_COLUMNS}
    img_shape = np.asarray(samples[0]["image"]).shape if samples else (63, 63, 3)
    if not samples:
        return {**out, "photo_valid": np.zeros((0, P), bool),
                "meta19": np.empty((0, 19), np.float32),
                "image": np.zeros((0, *img_shape), image_dtype)}

    # photometry: each curve a time-ascending prefix of its row, its earliest
    # P points; the lexsort and the index gather run only when needed
    lens = np.fromiter((len(s["photo_t"]) for s in samples), np.int64, count=B)
    cols = {k: _concat([s[k] for s in samples], dtype) for k, dtype, _ in _PHOTO_COLUMNS}
    t_all = cols["photo_t"]
    if t_all.shape[0] > 1:
        # NaN compares False and takes the sort
        asc = np.diff(t_all) >= 0
        bnd = np.cumsum(lens)[:-1] - 1  # comparisons across samples are exempt
        asc[bnd[(bnd >= 0) & (bnd < asc.shape[0])]] = True
        presorted = bool(asc.all())
    else:
        presorted = True
    kept = np.minimum(lens, P)
    valid = np.arange(P) < kept[:, None]
    if presorted and int(kept.sum()) == t_all.shape[0]:
        src = None
    else:
        keep = np.arange(t_all.shape[0], dtype=np.int64) - np.repeat(_starts(lens), lens) < P
        if presorted:
            src = np.flatnonzero(keep)
        else:
            PACK_COUNTS.add(photo_sorted=1)
            # stable by (sample, time): each sample's points stay in its rows
            src = np.lexsort((t_all, np.repeat(np.arange(B, dtype=np.int64), lens)))[keep]
    for k, _, _ in _PHOTO_COLUMNS:
        out[k][valid] = cols[k] if src is None else cols[k][src]
    out["photo_valid"] = valid
    out["meta19"] = np.stack([s["meta19"] for s in samples]).astype(np.float32, copy=False)
    out["image"] = np.empty((B, *img_shape), image_dtype)
    np.stack([s["image"] for s in samples], out=out["image"], casting="unsafe")
    return out


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
    out = _pack_rows(samples, max_photo, length_buckets, image_dtype)
    image = out.pop("image")
    B = len(samples)
    out.update(spec_wl=np.zeros((B, max_spec), np.float32),
               spec_flux=np.zeros((B, max_spec), np.float32),
               spec_valid=np.zeros((B, max_spec), bool),
               has_spectrum=np.zeros((B,), bool))
    spec_idx = [i for i, s in enumerate(samples) if _has_spectrum(s)]
    if spec_idx:
        _pack_spectra(samples, spec_idx, np.asarray(spec_idx, np.int64),
                      out["spec_wl"], out["spec_flux"], out["spec_valid"])
        out["has_spectrum"][spec_idx] = True
    out["image"] = image
    return out


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
    sub-batches before either is read back. ``mesh`` (in ``pipeline_kw``)
    shards each sub-batch over the data axis and gathers its rows.
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
        for pipe, with_spectrum, max_spec in ((self.full, True, 512), (self.nospec, False, 1)):
            idx = [i for i, s in enumerate(samples) if _has_spectrum(s) == with_spectrum]
            if not idx:
                parts.append((None, idx))
                continue
            raw = pack_alert_batch([samples[i] for i in idx], max_spec=max_spec,
                                   length_buckets=length_buckets)
            pad = self._bucket(len(idx)) - len(idx)
            if pad:  # pack the real alerts once, then tile the first row
                raw = {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in raw.items()}
            if pipe.mesh is not None:  # copy this rank's rows only
                parts.append((pipe.shard(raw).to(self.device), idx))
            else:
                parts.append(({k: torch.from_numpy(v).to(self.device) for k, v in raw.items()},
                              idx))
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
    raw = _pack_rows(samples, 257, length_buckets, np.float32)
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
        _pack_spectra(samples, spec_idx, 1 + np.arange(len(spec_idx), dtype=np.int64), wl, fx, vd)
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
    batch with zero spectra where there are none. ``mesh`` (in
    ``pipeline_kw``): ``place_packed`` copies this rank's rows and the whole
    spectra block, and the forward gathers the rows.
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
        """Copy a ``place(..., host_only=True)`` dict to the device (under a
        mesh, this rank's rows of it)."""
        if self.pipe.mesh is not None:
            return self.pipe.shard(raw).to(self.device)
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
