"""Minimal FITS primary-HDU image reader and writer (counterpart of
``applecider_tpu/preprocessing/fitsio.py``, the standard library and NumPy
only; the same pixels bit for bit).

ZTF alert cutouts are gzipped single-HDU FITS images
(``cutoutScience/Template/Difference -> stampData``). The reader handles the
primary HDU only: 2880-byte header blocks of 80-char cards, big-endian data
scaled by BSCALE/BZERO, which is everything an alert stamp holds.
"""

from __future__ import annotations

import gzip
import io
import zlib
from typing import Optional, Union

import numpy as np

BLOCK = 2880

_BITPIX_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}


def _parse_header(buf: bytes) -> tuple[dict, int]:
    """Parse primary header cards; return (header dict, data offset)."""
    header: dict = {}
    offset = 0
    while True:
        block = buf[offset : offset + BLOCK]
        if len(block) < BLOCK:
            raise ValueError("truncated FITS header")
        done = False
        for i in range(0, BLOCK, 80):
            card = block[i : i + 80].decode("ascii", errors="replace")
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if card[8:10] != "= ":
                continue
            value = card[10:].split("/")[0].strip()
            if value.startswith("'"):
                header[key] = value.strip("'").strip()
            elif value in ("T", "F"):
                header[key] = value == "T"
            else:
                try:
                    header[key] = int(value)
                except ValueError:
                    try:
                        header[key] = float(value)
                    except ValueError:
                        header[key] = value
        offset += BLOCK
        if done:
            break
    return header, offset


def read_fits_image(buf: bytes) -> np.ndarray:
    """Read the primary-HDU image from raw FITS bytes."""
    if not buf.startswith(b"SIMPLE"):
        raise ValueError("not a FITS file")
    header, offset = _parse_header(buf)
    bitpix = int(header["BITPIX"])
    naxis = int(header.get("NAXIS", 0))
    if naxis == 0:
        raise ValueError("no image data in primary HDU")
    shape = tuple(int(header[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
    dtype = _BITPIX_DTYPE[bitpix]
    count = int(np.prod(shape))
    data = np.frombuffer(buf, dtype=dtype, count=count, offset=offset).reshape(shape)
    out = data.astype(np.float32)
    bscale = float(header.get("BSCALE", 1.0))
    bzero = float(header.get("BZERO", 0.0))
    if bscale != 1.0 or bzero != 0.0:
        out = out * bscale + bzero
    return out


def decode_stamp(stamp: Union[bytes, bytearray, np.ndarray, None]) -> Optional[np.ndarray]:
    """Robust stamp decode with the reference's fallback ladder:
    ndarray pass-through -> gzip+FITS -> bare FITS -> .npy bytes -> None."""
    if stamp is None:
        return None
    if isinstance(stamp, np.ndarray):
        return stamp.astype(np.float32)
    if not isinstance(stamp, (bytes, bytearray)):
        return None
    raw = bytes(stamp)
    if raw[:2] == b"\x1f\x8b":
        try:
            raw_unzipped = gzip.decompress(raw)
            return read_fits_image(raw_unzipped)
        except (OSError, zlib.error, ValueError, KeyError):
            pass
    try:
        return read_fits_image(raw)
    except (ValueError, KeyError):
        pass
    try:
        arr = np.load(io.BytesIO(raw), allow_pickle=True)
        if isinstance(arr, np.ndarray):
            return arr.astype(np.float32)
    except Exception:
        pass
    return None


def write_fits_image(arr: np.ndarray, gzip_compress: bool = True) -> bytes:
    """Encode a 2-D float32 image as (optionally gzipped) FITS bytes.

    Used by tests and synthetic-data fixtures to fabricate ZTF-like stamps.
    """
    arr = np.asarray(arr, dtype=np.float32)
    cards = [
        "SIMPLE  =                    T",
        "BITPIX  =                  -32",
        f"NAXIS   =                    {arr.ndim}",
    ]
    for i, dim in enumerate(reversed(arr.shape), start=1):
        cards.append(f"NAXIS{i}  = {dim:>20d}")
    cards.append("END")
    header = "".join(c.ljust(80) for c in cards)
    header += " " * (-len(header) % BLOCK)
    data = arr.astype(">f4").tobytes()
    data += b"\x00" * (-len(data) % BLOCK)
    out = header.encode("ascii") + data
    return gzip.compress(out) if gzip_compress else out
