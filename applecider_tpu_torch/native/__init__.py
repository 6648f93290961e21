"""Native host code of the port: the batched gzip+FITS stamp decoder
(counterpart of ``applecider_tpu/native``).

``decode_stamps_batch`` decodes a list of stamp blobs in one call into
``fits_decoder.cpp``, whose threads gunzip and parse them; ctypes releases
the GIL for the call, so other Python threads run meanwhile. The source is
compiled with ``g++`` on first use into
``build/native/libacfits-<variant>-<hash>.so`` at the root of the checkout,
the hash covering the source and the flags, so an edited source builds anew
and an unchanged one is loaded as it is. Each process compiles to a
temporary file of its own and renames it into place, so processes that
build at once (``infer.feeder``'s spawned workers) each load a whole
library.

The libdeflate variant (its gzip decode is 2-3x zlib's) is built where a
probe compiles and links a program against ``libdeflate.h``; otherwise the
zlib variant is built. ``build_variant()`` says which. A failed build
raises with the compiler's output: there is no NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name("fits_decoder.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
VARIANTS = {
    "libdeflate": ("-DACFITS_HAVE_LIBDEFLATE", "-lz", "-ldeflate", "-lpthread"),
    "zlib": ("-lz", "-lpthread"),
}
_PROBE = ("#include <libdeflate.h>\n"
          "int main() { libdeflate_free_decompressor(libdeflate_alloc_decompressor()); }\n")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_variant: str | None = None


def _probe_libdeflate() -> bool:
    """True where ``CXX`` compiles and links a program against libdeflate."""
    try:
        out = subprocess.run([CXX, "-x", "c++", "-", "-o", os.devnull, "-ldeflate"],
                             input=_PROBE, capture_output=True, text=True, timeout=120)
    except OSError:
        return False
    return out.returncode == 0


def _library_path(variant: str) -> Path:
    h = hashlib.sha256()
    h.update(SRC.read_bytes())
    h.update(" ".join((CXX, *FLAGS, *VARIANTS[variant])).encode())
    return BUILD_DIR / f"libacfits-{variant}-{h.hexdigest()[:16]}.so"


def _build(variant: str) -> Path:
    """The library of ``variant``, compiled unless it is there already."""
    lib = _library_path(variant)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *FLAGS, str(SRC), "-o", str(tmp), *VARIANTS[variant]]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"building the stamp decoder failed: {' '.join(cmd)}: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the stamp decoder failed: {' '.join(cmd)}\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The decoder library, built on first use; raises if it cannot be built."""
    global _lib, _variant
    with _lock:
        if _lib is None:
            variant = "libdeflate" if _probe_libdeflate() else "zlib"
            lib = ctypes.CDLL(str(_build(variant)))
            lib.acfits_decode_batch.restype = ctypes.c_int
            lib.acfits_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int,
            ]
            _lib, _variant = lib, variant
        return _lib


def build_variant() -> str:
    """Which variant the loaded decoder is: "libdeflate" or "zlib"."""
    get_lib()
    return _variant


def decode_stamps_batch(stamps: list, hw: int = 63, n_threads: int = 0
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode a list of (gzipped or bare) FITS stamp blobs in one call.

    Returns (images (N, hw, hw) float32, ok (N,) bool). A blob that does not
    decode, or whose pixel count is not hw*hw, gets ok False and zeros. An
    ndarray entry of shape (hw, hw) passes through as float32; any other
    entry is not decoded (ok False). ``n_threads`` 0 uses every core the
    process may run on (``os.sched_getaffinity``: the C++ side's own count
    is the machine's, which overcommits a container held to fewer).
    """
    n = len(stamps)
    images = np.zeros((n, hw, hw), np.float32)
    ok = np.zeros(n, bool)
    byte_idx = []
    for i, s in enumerate(stamps):
        if isinstance(s, np.ndarray):
            if s.shape == (hw, hw):
                images[i] = s.astype(np.float32)
                ok[i] = True
        elif isinstance(s, (bytes, bytearray)):
            byte_idx.append(i)
    if not byte_idx:
        return images, ok

    lib = get_lib()
    blobs = [bytes(stamps[i]) for i in byte_idx]  # bytes as they are; a bytearray copied
    m = len(blobs)
    ptrs = (ctypes.c_void_p * m)(*[ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p) for b in blobs])
    sizes = (ctypes.c_int64 * m)(*[len(b) for b in blobs])
    max_pix = hw * hw
    counts = np.zeros(m, np.int64)
    # every entry bytes: decode straight into the result, with no staging copy
    out = images.reshape(n, max_pix) if m == n else np.zeros((m, max_pix), np.float32)
    lib.acfits_decode_batch(ptrs, sizes, m, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            max_pix, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                            int(n_threads) or len(os.sched_getaffinity(0)))
    good = counts == max_pix
    if m == n:
        ok[:] = good
        out[~good] = 0.0  # a failed decode may have written part of its row
    else:
        rows = np.asarray(byte_idx)[good]
        images[rows] = out[good].reshape(-1, hw, hw)
        ok[rows] = True
    return images, ok
