"""The int8 GEMM, convolution and depthwise convolution kernels
(``csrc/int8.cu``) at the serving shapes of ``chip_smoke.py`` phase 11a,
this checkout's beside another checkout's, in one process.

    python3 -m applecider_tpu_torch.tools.int8_timing [--earlier DIR]

Builds this checkout's ``int8`` library (``ops.kernel.build``) and, with
``--earlier``, ``DIR/applecider_tpu_torch/csrc/int8.cu`` with the same nvcc
flags into ``build/kernels/earlier/``: both export the same C entry points,
called here as ``ops.int8``'s wrappers call them (the convolutions'
weights permuted once, outside the timing). At each shape the two
libraries' int32 accumulators must be equal; then each is timed in turns
(earlier, this, this, earlier) on the same inputs, bf16 out with a bias,
with ``kernel_timing.time_ms`` as every kernel is timed (``ms``) and, for
the GEMMs and the depthwise convolutions, queued behind a sleep
(``device_ms``), beside ``torch._int_mm`` where that call takes the shape.
The depthwise rows also give the launch this checkout's library makes
(``ac_int8_dwconv_plan``) and their sum over a forward, each weighted by
its launches. Needs a GPU; prints the card's name and power limit first
and one JSON line last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from applecider_tpu_torch.ops import int8, kernel
from applecider_tpu_torch.tools.kernel_timing import time_ms

# (what, M, K, N): the serving path's dense layers at B = 512 alerts of 258
# tokens (the photometry transformer), and its small towers and heads
INT8_GEMMS = (("photometry in_proj 7->128", 512 * 258, 7, 128),
              ("attention in_proj 128->384", 512 * 258, 128, 384),
              ("FFN linear1 128->512", 512 * 258, 128, 512),
              ("FFN linear2 512->128", 512 * 258, 512, 128),
              ("metadata tower 19->128", 512, 19, 128),
              ("router 128->4", 512, 128, 4))
INT8_GEMM_TIMED = 1  # the attention in_proj
# the largest spectra block of a 512-alert serving batch: 192 spectra (the
# spectra bucket above phase 3b's 123-162 a batch) and the zero row
SPEC_BLOCK = 193
# (what, B, H, W, Cin, Cout, kh, kw, stride, pad): ConvNeXt's stem and a
# downsample on 63x63 images (B = 512), then SpectraNet's convolutions on
# that spectra block (conv1d as a 1 x L image): every bank convolution
# ('same', stride 1) and the 1x1 downsample of each stage, at its length
INT8_CONVS = (("ConvNeXt stem 4x4/4 3->96", 512, 63, 63, 3, 96, 4, 4, 4, 0),
              ("ConvNeXt downsample 2x2/2 96->192", 512, 15, 15, 96, 192, 2, 2, 2, 0),
              ("SpectraNet stage 0 K=1021 1->64", SPEC_BLOCK, 1, 3481, 1, 64, 1, 1021, 1, 510),
              ("SpectraNet stage 1 K=31 64->128", SPEC_BLOCK, 1, 870, 64, 128, 1, 31, 1, 15),
              ("SpectraNet stage 1 K=251 64->128", SPEC_BLOCK, 1, 870, 64, 128, 1, 251, 1, 125),
              ("SpectraNet downsample 1x1 192->64", SPEC_BLOCK, 1, 3481, 192, 64, 1, 1, 1, 0),
              ("SpectraNet stage 0 K=3 1->64", SPEC_BLOCK, 1, 3481, 1, 64, 1, 3, 1, 1),
              ("SpectraNet stage 0 K=61 1->64", SPEC_BLOCK, 1, 3481, 1, 64, 1, 61, 1, 30),
              ("SpectraNet stage 1 K=3 64->128", SPEC_BLOCK, 1, 870, 64, 128, 1, 3, 1, 1),
              ("SpectraNet downsample 1x1 384->128", SPEC_BLOCK, 1, 870, 384, 128, 1, 1, 1, 0),
              ("SpectraNet stage 2 K=3 128->256", SPEC_BLOCK, 1, 217, 128, 256, 1, 3, 1, 1),
              ("SpectraNet stage 2 K=15 128->256", SPEC_BLOCK, 1, 217, 128, 256, 1, 15, 1, 7),
              ("SpectraNet stage 2 K=61 128->256", SPEC_BLOCK, 1, 217, 128, 256, 1, 61, 1, 30),
              ("SpectraNet downsample 1x1 768->256", SPEC_BLOCK, 1, 217, 768, 256, 1, 1, 1, 0),
              ("SpectraNet stage 3 K=3 256->512", SPEC_BLOCK, 1, 54, 256, 512, 1, 3, 1, 1),
              ("SpectraNet stage 3 K=11 256->512", SPEC_BLOCK, 1, 54, 256, 512, 1, 11, 1, 5),
              ("SpectraNet stage 3 K=31 256->512", SPEC_BLOCK, 1, 54, 256, 512, 1, 31, 1, 15),
              ("SpectraNet downsample 1x1 1536->512", SPEC_BLOCK, 1, 54, 1536, 512, 1, 1, 1, 0),
              ("SpectraNet stage 4 K=3 512->1024", SPEC_BLOCK, 1, 13, 512, 1024, 1, 3, 1, 1),
              ("SpectraNet stage 4 K=7 512->1024", SPEC_BLOCK, 1, 13, 512, 1024, 1, 7, 1, 3),
              ("SpectraNet stage 4 K=13 512->1024", SPEC_BLOCK, 1, 13, 512, 1024, 1, 13, 1, 6))
INT8_CONV_TIMED = 3  # SpectraNet stage 1's K = 31 bank convolution
# (what, B, H, W, C, launches a forward): the 7x7 pad 3 depthwise convolution
# of every ConvNeXt block (default depths 3, 3, 9, 3) on 63x63 stamps, B = 512
INT8_DWCONVS = tuple((f"ConvNeXt dwconv 7x7 {h}x{h}x{c}", 512, h, h, c, n)
                     for h, c, n in ((15, 96, 3), (7, 192, 3), (3, 384, 9), (1, 768, 3)))
DWCONV_KERNEL, DWCONV_PAD = 7, 3
# ac_int8_dwconv_plan's fields, and its DwLoad names
DWCONV_PLAN = ("tile", "R", "images", "channels", "slices", "blocks", "smem", "load")
DWCONV_LOADS = ("cp.async 16", "bytes")


def conv_geometry(B, H, W, C, Cout, kh, kw, s, p) -> tuple:
    """(stride, padding, M, K) of a row of ``INT8_CONVS``; a 1 x L image
    strides and pads along its length only."""
    stride, pad = ((1, s), (0, p)) if H == 1 else ((s, s), (p, p))
    Ho = int8.conv_output_size(H, kh, stride[0], pad[0])
    Wo = int8.conv_output_size(W, kw, stride[1], pad[1])
    return stride, pad, B * Ho * Wo, C * kh * kw


class Int8Library:
    """``ac_int8_gemm``, ``ac_int8_conv`` and ``ac_int8_dwconv`` of one built
    int8 library, called with the arguments ``ops.int8.gemm`` and ``conv2d``
    pass."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        for k in (int8.KERNEL_GEMM, int8.KERNEL_CONV, int8.KERNEL_DWCONV):
            fn = getattr(lib, k.symbol)
            fn.argtypes = [*k.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int

    def _call(self, symbol: str, *args) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(self._lib, symbol)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed (cudaError {err})")

    def gemm(self, a, b, scale, bias, out_dtype) -> torch.Tensor:
        (M, K), N = a.shape, b.shape[0]
        out = torch.empty((M, N), dtype=out_dtype, device=a.device)
        self._call("ac_int8_gemm", a, b, scale, bias, out, M, N, K, int8._out_code(out_dtype))
        return out

    def conv(self, x, wk, scale, bias, out_dtype, stride, pad) -> torch.Tensor:
        """``wk`` is the (Cout, kh, kw, C) weight the wrapper passes."""
        B, H, W, C = x.shape
        Cout, kh, kw, _ = wk.shape
        Ho = int8.conv_output_size(H, kh, stride[0], pad[0])
        Wo = int8.conv_output_size(W, kw, stride[1], pad[1])
        out = torch.empty((B, Ho, Wo, Cout), dtype=out_dtype, device=x.device)
        self._call("ac_int8_conv", x, wk, scale, bias, out, B, H, W, C, Ho, Wo, Cout, kh, kw,
                   *stride, *pad, int8._out_code(out_dtype))
        return out

    @staticmethod
    def _dw_args(x, kh, kw, out_dtype, stride, pad) -> tuple:
        """The depthwise output of ``x`` and the geometry ``ac_int8_dwconv``
        takes after the pointers, up to the out dtype."""
        B, H, W, C = x.shape
        Ho = int8.conv_output_size(H, kh, stride[0], pad[0])
        Wo = int8.conv_output_size(W, kw, stride[1], pad[1])
        out = torch.empty((B, Ho, Wo, C), dtype=out_dtype, device=x.device)
        return out, (B, H, W, C, Ho, Wo, kh, kw, *stride, *pad, int8._out_code(out_dtype))

    def dwconv(self, x, wk, scale, bias, out_dtype, stride, pad) -> torch.Tensor:
        """``wk`` is the (kh, kw, C) weight the wrapper passes."""
        out, geometry = self._dw_args(x, *wk.shape[:2], out_dtype, stride, pad)
        self._call("ac_int8_dwconv", x, wk, scale, bias, out, *geometry)
        return out

    def dwconv_plan(self, x, kh, kw, out_dtype, stride, pad) -> dict:
        """The launch ``dwconv`` makes on ``x`` (``ac_int8_dwconv_plan``):
        {"path": "tile" or "general", and for the tile kernel its R, images
        a block, channels a slice, slices, blocks, shared bytes, load}."""
        out, geometry = self._dw_args(x, kh, kw, out_dtype, stride, pad)
        fn = self._lib.ac_int8_dwconv_plan
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 12 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        plan = (ctypes.c_int64 * len(DWCONV_PLAN))()
        err = fn(x.data_ptr(), out.data_ptr(), *geometry, plan)
        if err != 0:
            raise RuntimeError(f"ac_int8_dwconv_plan failed (cudaError {err})")
        fields = dict(zip(DWCONV_PLAN, plan))
        if not fields.pop("tile"):
            return {"path": "general"}
        return {"path": "tile", **fields, "load": DWCONV_LOADS[fields["load"]]}


def build_earlier(root: Path) -> ctypes.CDLL:
    """``root``'s ``csrc/int8.cu`` built with this checkout's nvcc flags."""
    csrc = Path(root) / "applecider_tpu_torch" / "csrc"
    h = hashlib.sha256()
    for f in [csrc / "int8.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(f.read_bytes())
    lib = kernel.BUILD_DIR / "earlier" / f"libint8-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([kernel._nvcc(), *kernel.NVCC_FLAGS, "-o", str(lib),
                               str(csrc / "int8.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / 'int8.cu'}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _in_turns(fns: dict, **kw) -> dict:
    """Each of ``fns`` timed twice, in the order earlier, this, this,
    earlier: {name: [ms, ms]}."""
    order = ["earlier", "this", "this", "earlier"] if "earlier" in fns else ["this", "this"]
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(time_ms(fns[name], **kw))
    return times


def time_int8(libs: dict, device, seed: int = 11) -> list[dict]:
    """Every row of ``INT8_GEMMS`` and ``INT8_CONVS`` with each library of
    ``libs`` ({"this": ..., "earlier": ...}); raises if two libraries'
    int32 accumulators differ."""
    rng = np.random.default_rng(seed)

    def ints(shape):
        return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(np.int8)).to(device)

    def agree(outs: dict, what: str) -> None:
        first = next(iter(outs.values()))
        if any(not torch.equal(first, o) for o in outs.values()):
            raise SystemExit(f"int8 {what}: the libraries' int32 accumulators differ")

    rows = []
    for what, M, K, N in INT8_GEMMS:
        a, b = ints((M, K)), ints((N, K))
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, N).astype(np.float32)).to(device)
        bias = torch.from_numpy(rng.normal(size=N).astype(np.float32)).to(device)
        agree({k: lib.gemm(a, b, None, None, torch.int32) for k, lib in libs.items()}, what)
        fns = {k: (lambda lib=lib: lib.gemm(a, b, scale, bias, torch.bfloat16))
               for k, lib in libs.items()}
        row = {"kind": "int8_gemm", "what": what, "M": M, "K": K, "N": N,
               "ms": _in_turns(fns), "device_ms": _in_turns(fns, queued=True),
               "int_mm_ms": (time_ms(lambda: torch._int_mm(a, b.t()))
                             if M > 16 and K % 8 == 0 and N % 8 == 0 else None)}
        rows.append(row)
        _log(row)
        del a, b
    for what, B, H, W, C, Cout, kh, kw, s, p in INT8_CONVS:
        stride, pad, M, K = conv_geometry(B, H, W, C, Cout, kh, kw, s, p)
        x, w = ints((B, H, W, C)), ints((Cout, C, kh, kw))
        wk = w.permute(0, 2, 3, 1).contiguous()
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, Cout).astype(np.float32)).to(device)
        bias = torch.from_numpy(rng.normal(size=Cout).astype(np.float32)).to(device)
        agree({k: lib.conv(x, wk, None, None, torch.int32, stride, pad)
               for k, lib in libs.items()}, what)
        fns = {k: (lambda lib=lib: lib.conv(x, wk, scale, bias, torch.bfloat16, stride, pad))
               for k, lib in libs.items()}
        row = {"kind": "int8_conv", "what": what, "M": M, "K": K, "N": Cout,
               "ms": _in_turns(fns, iters=3, reps=3)}
        rows.append(row)
        _log(row)
        del x, w, wk
    k, p = DWCONV_KERNEL, DWCONV_PAD
    for what, B, H, W, C, n in INT8_DWCONVS:
        x, wk = ints((B, H, W, C)), ints((k, k, C))
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, C).astype(np.float32)).to(device)
        bias = torch.from_numpy(rng.normal(size=C).astype(np.float32)).to(device)
        agree({name: lib.dwconv(x, wk, None, None, torch.int32, (1, 1), (p, p))
               for name, lib in libs.items()}, what)
        fns = {name: (lambda lib=lib: lib.dwconv(x, wk, scale, bias, torch.bfloat16, (1, 1),
                                                 (p, p)))
               for name, lib in libs.items()}
        row = {"kind": "int8_dwconv", "what": what, "M": B * H * W, "K": k * k, "N": C,
               "launches_a_forward": n, "ms": _in_turns(fns),
               "device_ms": _in_turns(fns, queued=True),
               "plan": libs["this"].dwconv_plan(x, k, k, torch.bfloat16, (1, 1), (p, p))}
        rows.append(row)
        _log(row)
        del x, wk
    for name in libs:
        ms, dev = (sum(min(r[key][name]) * r["launches_a_forward"]
                       for r in rows if r["kind"] == "int8_dwconv") for key in ("ms", "device_ms"))
        print(f"int8_dwconv {name}: a forward's {sum(n for *_, n in INT8_DWCONVS)} depthwise "
              f"launches, weighted by launches: {ms:.4f} ms (device {dev:.4f})", flush=True)
    torch.cuda.empty_cache()
    return rows


def _log(row: dict) -> None:
    ops = 2.0 * row["M"] * row["N"] * row["K"]  # depthwise: M pixels x N channels x K taps
    parts = []
    for k in ("this", "earlier"):
        if k in row["ms"]:
            ms = row["ms"][k]
            dev = f", device {row['device_ms'][k]}" if "device_ms" in row else ""
            parts.append(f"{k} {ms}{dev} ms ({ops / min(ms) / 1e9:.1f} TOPS)")
    lib = f"; torch._int_mm {row['int_mm_ms']:.4f} ms" if row.get("int_mm_ms") else ""
    lib += f"; {row['plan']}" if "plan" in row else ""
    print(f"{row['kind']} {row['what']} M={row['M']} K={row['K']} N={row['N']}: "
          f"{'; '.join(parts)}{lib}", flush=True)


def main() -> None:
    from applecider_tpu_torch.device import card_name_and_power

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", type=Path, help="root of another checkout whose int8.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_timing needs a GPU")
    card = card_name_and_power()
    print(f"card: {card}", flush=True)
    kernel.build(["int8"])
    libs = {"this": Int8Library(kernel._libs["int8"])}
    if args.earlier is not None:
        libs["earlier"] = Int8Library(build_earlier(args.earlier))
    rows = time_int8(libs, torch.device("cuda"))
    print(card, flush=True)
    print(json.dumps({"card": card, "earlier": str(args.earlier), "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
