"""The port's host readers (no pandas) == the JAX package's (pandas) on the
same files, bit for bit: photometry, spectra, stamps, the metadata vector
and the synthetic raw corpus, plus the CSV edge cases the readers meet."""

import gzip

import numpy as np
import pandas as pd
import pytest

from applecider_tpu.preprocessing import builder as jb
from applecider_tpu.preprocessing import fitsio as jf
from applecider_tpu.preprocessing import photometry as jp
from applecider_tpu.preprocessing import spectra as jsp
from applecider_tpu.testing import make_corpus as jax_make_corpus
from applecider_tpu_torch.preprocessing import builder as tb
from applecider_tpu_torch.preprocessing import fitsio as tf
from applecider_tpu_torch.preprocessing import photometry as tp
from applecider_tpu_torch.preprocessing import spectra as tsp
from applecider_tpu_torch.preprocessing.table import parse_float, read_csv
from applecider_tpu_torch.testing import make_corpus as port_make_corpus


def assert_bit_equal(a, b, what=""):
    """Same structure, same types, same bits (NaN == NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), what
        for k in a:
            assert_bit_equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def assert_frame_equal(table, df):
    """A port ``Table`` holds the columns ``pandas.read_csv`` gives."""
    if df is None:
        assert table is None
        return
    assert list(table.columns) == list(df.columns)
    assert len(table) == len(df)
    for c in df.columns:
        want = df[c].to_numpy()
        got = table[c]
        if want.dtype == object:
            assert got.dtype == object, c
            for g, w in zip(got, want):
                assert_bit_equal(g, w, c)
        else:
            assert_bit_equal(got, want, c)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir, _ = jax_make_corpus(tmp_path_factory.mktemp("corpus"), n_objects=6, seed=7,
                                  n_photometry=24, n_alerts=5)
    return data_dir


def _ids(data_dir):
    return sorted(p.name for p in data_dir.iterdir())


def test_load_photometry_bit_equal(corpus):
    for obj in _ids(corpus):
        assert_bit_equal(tp.load_photometry(obj, corpus), jp.load_photometry(obj, corpus), obj)


def test_spectra_readers_bit_equal(corpus):
    for obj in _ids(corpus) + ["missing"]:
        table, df = tsp.read_spectra_csv(obj, corpus), jsp.read_spectra_csv(obj, corpus)
        assert_frame_equal(table, df)
        assert_bit_equal(tsp.extract_spectrum_time_mjd(table), jsp.extract_spectrum_time_mjd(df))
        got, want = tsp.raw_spectrum_columns(table), jsp.raw_spectrum_columns(df)
        assert (got is None) == (want is None)
        for g, w in zip(got or (), want or ()):
            assert_bit_equal(g, w)


def _int16_stamp(rng):
    img = rng.integers(-100, 100, size=(63, 63)).astype(np.int16)
    cards = ["SIMPLE  =                    T", "BITPIX  =                   16",
             "NAXIS   =                    2", "NAXIS1  =                   63",
             "NAXIS2  =                   63", "BSCALE  =                  0.5",
             "BZERO   =                 10.0", "END"]
    header = "".join(c.ljust(80) for c in cards)
    header += " " * (-len(header) % 2880)
    data = img.astype(">i2").tobytes()
    return header.encode() + data + b"\x00" * (-len(data) % 2880)


@pytest.mark.parametrize("kind", ["gzip", "raw", "int16_bzero", "int16_gzip", "ndarray", "npy",
                                  "garbage", "none", "not_bytes"])
def test_decode_stamp_bit_equal(rng, kind):
    img = rng.normal(size=(63, 63)).astype(np.float32)
    blob = {
        "gzip": lambda: jf.write_fits_image(img, gzip_compress=True),
        "raw": lambda: jf.write_fits_image(img, gzip_compress=False),
        "int16_bzero": lambda: _int16_stamp(rng),
        "int16_gzip": lambda: gzip.compress(_int16_stamp(rng)),
        "ndarray": lambda: img.astype(np.float64),
        "npy": lambda: _npy_bytes(img),
        "garbage": lambda: b"\x1f\x8bnot a stamp",
        "none": lambda: None,
        "not_bytes": lambda: "a string",
    }[kind]()
    got, want = tf.decode_stamp(blob), jf.decode_stamp(blob)
    assert (got is None) == (want is None)
    if want is not None:
        assert_bit_equal(got, want)
    if kind in ("gzip", "raw"):
        np.testing.assert_array_equal(got, img)
    if kind == "raw":
        assert tf.write_fits_image(img, gzip_compress=False) == blob


def _npy_bytes(a):
    import io

    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_meta_vector_bit_equal(corpus):
    cands = [dict(a["candidate"]) for obj in _ids(corpus)
             for a in np.load(corpus / obj / "alerts.npy", allow_pickle=True)]
    cands += [{}, {"ra": "12.5", "dec": None, "rb": float("nan"), "fid": "x", "sgscore1": np.inf,
                   "magpsf": np.float32(18.25), "ndethist": np.int64(7)}]
    for c in cands:
        assert_bit_equal(tb._meta_vector(c), jb._meta_vector(c))
    assert tb.ALERT_META_KEEP == jb.ALERT_META_KEEP and tb.MISSING == jb.MISSING


def _alerts_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert list(x) == list(y)
        assert_bit_equal(x["candidate"], y["candidate"])
        for k in ("cutoutScience", "cutoutTemplate", "cutoutDifference"):
            # gzip headers carry the write time; the FITS bytes inside are the same
            assert gzip.decompress(x[k]["stampData"]) == gzip.decompress(y[k]["stampData"])


@pytest.mark.parametrize("kw", [{}, {"learnable": True, "n_alerts": 3, "n_photometry": 12}])
def test_make_corpus_matches_jax(tmp_path, kw):
    args = dict(n_objects=5, seed=11, **kw)
    jd, jl = jax_make_corpus(tmp_path / "jax", **args)
    td, tl = port_make_corpus(tmp_path / "port", **args)
    assert jl.read_bytes() == tl.read_bytes()
    assert _ids(jd) == _ids(td)
    for obj in _ids(jd):
        for name in ("photometry.csv", "spectra.csv"):
            assert (jd / obj / name).read_bytes() == (td / obj / name).read_bytes()
        _alerts_equal(np.load(jd / obj / "alerts.npy", allow_pickle=True),
                      np.load(td / obj / "alerts.npy", allow_pickle=True))


def test_make_corpus_ranges(tmp_path):
    data_dir, _ = port_make_corpus(tmp_path, n_objects=20, seed=3, n_photometry=(20, 300),
                                   n_alerts=4, spectrum_frac=0.3)
    lens = [len((data_dir / o / "photometry.csv").read_text().splitlines()) - 1
            for o in _ids(data_dir)]
    assert min(lens) >= 20 and max(lens) <= 300 and len(set(lens)) > 10
    n_spec = sum((data_dir / o / "spectra.csv").exists() for o in _ids(data_dir))
    assert 0 < n_spec < 20


# ------------------------------------------------------------- CSV edge cases
PHOTOMETRY_CASES = {
    "empty_cells": "jd,mag,magerr,fid\n2459001.5,18.2,0.1,1\n2459002.5,,0.1,2\n"
                   "2459003.5,18.4,,1\n2459004.5,18.5,0.2,\n,18.6,0.1,3\n",
    "filter_names": "mjd,MagPSF,SigmaPSF,filter\n59001.25,18.2,0.1,ztfg\n59002.5,18.3,0.1, R\n"
                    "59003.75,18.4,0.2,i\n59004.0,18.5,0.1,ZTFI\n59005.0,18.6,0.1,u\n",
    "fid_and_filter": "JD,mag,magerr,fid,filter\n2459001.5,18.2,0.1,,ztfr\n2459002.5,18.3,0.1,3,g\n"
                      "2459003.5,18.4,0.1,7,g\n",
    "long_digits": "jd,mag,magerr,fid\n2459001.12345678901234567,18.234567890123456789,"
                   "0.10000000000000001,1\n2459002.9999999999999999,17.0000000000000017,"
                   "0.0999999999999999917,2\n",
    "text_fid": "jd,mag,magerr,fid\n2459001.5,18.2,0.1,1.0\n2459002.5,18.3,0.1,two\n",
    "header_only": "jd,mag,magerr,fid\n",
    "no_magnitude": "jd,flux,fid\n2459001.5,10.0,1\n",
    "blank_lines_short_rows": "jd,mag,magerr,fid\n\n2459001.5,18.2,0.1,1\n2459002.5,18.3\n\n",
    "na_strings": "jd,mag,magerr,fid\n2459001.5,NaN,0.1,1\n2459002.5,18.3,NULL,2\n"
                  "2459003.5,18.4,0.1,N/A\n2459004.5,inf,0.1,1\n",
}


@pytest.mark.parametrize("case", sorted(PHOTOMETRY_CASES))
def test_photometry_csv_edge_cases_match_jax(tmp_path, case):
    obj = tmp_path / "ZTF1"
    obj.mkdir()
    (obj / "photometry.csv").write_text(PHOTOMETRY_CASES[case])
    assert_frame_equal(read_csv(obj / "photometry.csv"), pd.read_csv(obj / "photometry.csv"))
    assert_bit_equal(tp.read_csv_photometry("ZTF1", tmp_path),
                     jp.read_csv_photometry("ZTF1", tmp_path))
    alerts = [{"candidate": {"jd": 2459001.5, "magpsf": 18.0, "sigmapsf": 0.05, "fid": 1}}]
    assert_bit_equal(tp.load_photometry("ZTF1", tmp_path, alerts=alerts),
                     jp.load_photometry("ZTF1", tmp_path, alerts=alerts))


def test_non_numeric_magnitude_raises_like_jax(tmp_path):
    obj = tmp_path / "ZTF1"
    obj.mkdir()
    (obj / "photometry.csv").write_text("jd,mag,magerr,fid\n2459001.5,18.2,0.1,1\n"
                                        "2459002.5,bright,0.1,2\n")
    with pytest.raises(ValueError):
        jp.read_csv_photometry("ZTF1", tmp_path)
    with pytest.raises(ValueError):
        tp.read_csv_photometry("ZTF1", tmp_path)


SPECTRA_CASES = {
    "ztfid_filter": "ZTFID,wavelength,flux,mjd\nZTF1,4000.0,1e-16,59000.5\nZTF2,4001.0,2e-16,59100.5\n"
                    ",4002.0,3e-16,59000.75\nZTF1,4003.0,4e-16,59001.5\nnan,4004.0,5e-16,\n",
    "ztfid_other_only": "ZTFID,wavelength,flux,mjd\nZTF2,4000.0,1e-16,59000.5\nZTF3,4001.0,2e-16,59000.5\n",
    "observed_at_iso": "wave,Flux,observed_at\n4000,1.5,2020-06-01T12:00:00Z\n4001,1.6,\n"
                       "4002,1.7,2020-06-01T12:00:00\n",
    "observed_at_bad_then_good": "wl,flam,observed_at\n4000,1.5,yesterday\n4001,1.6,2020-06-02 06:30:00\n",
    "jd_column": "lambda,fluxcal,JD\n4000.5,1.0,2459000.25\n4001.5,2.0,bad\n4002.5,,2459001.25\n",
    "text_mjd_and_flux": "wavelength,flux,MJD\n4000,1.0,59000.123456789012345\n4001,x,n/a\n"
                         "4002,3.0,59000.5\n4003,4.0,later\n",
    "empty_cells": "wavelength,flux,mjd\n4000,,59000.5\n,2.0,\n4002,3.0,\n4003,4.0,59000.5\n",
    "one_point": "wavelength,flux,mjd\n4000,1.0,59000.5\n",
    "no_flux_column": "wavelength,counts,mjd\n4000,1.0,59000.5\n4001,2.0,59000.5\n",
    "header_only": "wavelength,flux,mjd\n",
    "duplicate_and_unnamed": "wavelength,flux,flux,,mjd\n4000,1.0,5.0,x,59000.5\n4001,2.0,6.0,y,59000.5\n",
    "empty_file": "",
}


@pytest.mark.parametrize("case", sorted(SPECTRA_CASES))
def test_spectra_csv_edge_cases_match_jax(tmp_path, case):
    obj = tmp_path / "ZTF1"
    obj.mkdir()
    (obj / "spectra.csv").write_text(SPECTRA_CASES[case])
    table, df = tsp.read_spectra_csv("ZTF1", tmp_path), jsp.read_spectra_csv("ZTF1", tmp_path)
    assert_frame_equal(table, df)
    assert_bit_equal(tsp.extract_spectrum_time_mjd(table), jsp.extract_spectrum_time_mjd(df))
    got, want = tsp.raw_spectrum_columns(table), jsp.raw_spectrum_columns(df)
    assert (got is None) == (want is None)
    for g, w in zip(got or (), want or ()):
        assert_bit_equal(g, w)


def test_iso_to_mjd_matches_jax():
    for s in ("2020-06-01T12:00:00Z", "2020-06-01 12:00:00", "2021-01-01T00:00:00.5+02:00",
              " 1999-12-31T23:59:59 "):
        assert_bit_equal(tsp.iso_to_mjd(s), jsp.iso_to_mjd(s))
    with pytest.raises(ValueError):
        tsp.iso_to_mjd("not a date")


def test_parse_float_matches_pandas_bit_for_bit(rng):
    """pandas' default C parser is not correctly rounded past 15-17
    significant digits; the port's parser reproduces its bits."""
    vals = []
    for k in range(20000):
        nd = int(rng.integers(1, 24))
        digits = "".join(str(d) for d in rng.integers(0, 10, nd))
        pos = int(rng.integers(0, nd + 1))
        s = digits[:pos] + "." + digits[pos:] if k % 5 else digits
        if k % 3 == 0:
            s += "eE"[k % 2] + str(int(rng.integers(-330, 330)))
        vals.append("-" + s if k % 7 == 0 else s)
    import io

    want = pd.read_csv(io.StringIO("a\n" + "\n".join(vals) + "\n"))["a"].to_numpy()
    got = np.asarray([parse_float(v) for v in vals])
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    correctly_rounded = np.asarray([float(v) for v in vals])
    assert (correctly_rounded != want).sum() > 100  # float() is not pandas' parser
    for s in ("-1e-700", "-0e400", "-5e-400", "-0", "0e-700", "-0e-700", "1e309", "-2.5e-320"):
        want = pd.read_csv(io.StringIO(f"a\n{s}\n1.5\n"))["a"].to_numpy()[:1]
        np.testing.assert_array_equal(np.asarray([parse_float(s)]).view(np.uint64),
                                      want.view(np.uint64), err_msg=s)
    for s in (".", "-", "e5", "1e", "1e+", " ", "0x10", "1_0", "nan"):
        assert parse_float(s) is None, s
    assert parse_float("-Infinity") == -np.inf and parse_float(" 1.5 ") == 1.5
