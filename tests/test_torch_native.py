"""The port's native stamp decoder: ``decode_stamps_batch`` equals the JAX
package's native decoder and the port's ``decode_stamp`` bit for bit
(gzipped and bare FITS, int16 with BSCALE/BZERO, the wrong size, garbage,
ndarray pass-through); with a BSCALE/BZERO that float32 rounds, it keeps
the NumPy reader's float32 arithmetic; a failed build raises with the
compiler's output, with no fallback; processes that build at once each
load a whole library."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from applecider_tpu.native import decode_stamps_batch as jax_decode_stamps_batch
from applecider_tpu_torch import native
from applecider_tpu_torch.preprocessing.fitsio import decode_stamp, write_fits_image

REPO = Path(__file__).resolve().parents[1]


def _int16_blob(img: np.ndarray, bscale: str, bzero: str) -> bytes:
    """A bare FITS image of int16 pixels with BSCALE and BZERO cards."""
    h, w = img.shape
    cards = ["SIMPLE  =                    T", "BITPIX  =                   16",
             "NAXIS   =                    2", f"NAXIS1  = {w:>20d}", f"NAXIS2  = {h:>20d}",
             f"BSCALE  = {bscale:>20}", f"BZERO   = {bzero:>20}", "END"]
    header = "".join(c.ljust(80) for c in cards)
    header += " " * (-len(header) % 2880)
    data = img.astype(">i2").tobytes()
    return header.encode() + data + b"\x00" * (-len(data) % 2880)


def _cases(rng) -> dict:
    img = rng.normal(size=(63, 63)).astype(np.float32)
    ints = rng.integers(-100, 100, size=(63, 63)).astype(np.int16)
    return {
        "gzipped": write_fits_image(img),
        "uncompressed": write_fits_image(img, gzip_compress=False),
        "int16_bscale_bzero": _int16_blob(ints, "0.5", "10.0"),
        "wrong_size": write_fits_image(img[:60]),
        "garbage": b"garbage",
        "ndarray": rng.normal(size=(63, 63)),
    }


@pytest.mark.parametrize("case", ["gzipped", "uncompressed", "int16_bscale_bzero", "wrong_size",
                                  "garbage", "ndarray"])
def test_decode_matches_jax_and_decode_stamp(rng, case):
    cases = _cases(rng)
    stamps = [cases[case], cases["gzipped"]]  # a mixed list, and one blob alone
    for batch in (stamps, stamps[:1]):
        got, ok = native.decode_stamps_batch(batch)
        want, want_ok = jax_decode_stamps_batch(batch)
        assert got.dtype == np.float32 and got.shape == (len(batch), 63, 63)
        np.testing.assert_array_equal(ok, want_ok)
        assert got.tobytes() == want.tobytes()
        for i, stamp in enumerate(batch):
            ref = decode_stamp(stamp)
            if ref is not None and ref.shape == (63, 63):
                assert ok[i] and got[i].tobytes() == ref.tobytes()
            else:
                assert not ok[i] and not got[i].any()
    expect_ok = case not in ("wrong_size", "garbage")
    assert bool(native.decode_stamps_batch(stamps[:1])[1][0]) == expect_ok


def test_scaling_keeps_the_numpy_readers_float32(rng):
    """BSCALE 0.1 and BZERO 3.3 round in float32: the port's decoder equals
    ``decode_stamp`` bit for bit (the JAX package's decoder computes in
    double and differs by an ulp here)."""
    ints = rng.integers(-30000, 30000, size=(63, 63)).astype(np.int16)
    blob = _int16_blob(ints, "0.1", "3.3")
    got, ok = native.decode_stamps_batch([blob])
    assert ok[0] and got[0].tobytes() == decode_stamp(blob).tobytes()


def test_build_variant_and_library_place():
    assert native.build_variant() in ("libdeflate", "zlib")
    lib = native._library_path(native.build_variant())
    assert lib.exists() and lib.parent == REPO / "build" / "native"


@pytest.mark.parametrize("fault", ["missing_compiler", "compile_error"])
def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    if fault == "missing_compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "no" / "g++"))
        match = "No such file"
    else:
        broken = tmp_path / "fits_decoder.cpp"
        broken.write_text("int acfits_decode_batch( {\n")
        monkeypatch.setattr(native, "SRC", broken)
        match = "error"
    with pytest.raises(RuntimeError, match=f"building the stamp decoder failed(.|\n)*{match}"):
        native.decode_stamps_batch([write_fits_image(np.zeros((63, 63), np.float32))])
    assert not list((tmp_path / "native").glob("*.so"))


def test_processes_building_at_once_both_load(tmp_path):
    """Two interpreters build into one empty directory at once: each loads a
    whole library and decodes; one library is left, and no temporary."""
    code = textwrap.dedent(f"""
        from pathlib import Path
        import numpy as np
        from applecider_tpu_torch import native
        from applecider_tpu_torch.preprocessing.fitsio import write_fits_image

        native.BUILD_DIR = Path({str(tmp_path / "native")!r})
        img = np.arange(63 * 63, dtype=np.float32).reshape(63, 63)
        images, ok = native.decode_stamps_batch([write_fits_image(img)])
        assert ok.all() and (images[0] == img).all()
        print(native.build_variant())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    assert outs[0][0] == outs[1][0]
    assert [p.name for p in (tmp_path / "native").iterdir()] == \
        [native._library_path(outs[0][0].strip()).name]
