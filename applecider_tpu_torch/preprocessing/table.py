"""CSV files as small column tables, read with the standard library's
``csv`` module into NumPy columns.

The JAX package reads ``photometry.csv`` and ``spectra.csv`` with
``pandas.read_csv``; the card's machine has no pandas, so the port reads
them here and gives the same columns on the files the readers see:

* a cell in ``NA_VALUES`` (the empty cell among them) is missing: NaN;
* a column whose present cells are all integers is int64 (float64 when a
  cell is missing); all numbers, float64; anything else stays text, an
  object array of ``str`` with NaN where a cell is missing (pandas makes a
  column of ``True``/``False`` bool; no reader reads one);
* numbers are parsed as pandas' default C parser parses them
  (``parse_float``), which is not always correctly rounded: 17 significant
  digits are accumulated in a double, the rest dropped, then one product
  or quotient by a power of ten. Python's ``float`` rounds correctly and
  differs from it on many strings of 17 or more digits;
* repeated names become ``name.1``, ``name.2``, …, an empty name
  ``Unnamed: i``; blank lines are skipped; short rows are padded with
  missing cells, and a row longer than the header raises.
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Optional

import numpy as np

NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INF = {"inf": float("inf"), "+inf": float("inf"), "infinity": float("inf"),
        "+infinity": float("inf"), "-inf": float("-inf"), "-infinity": float("-inf")}

_WS = "[ \t\n\v\f\r]*"
_NUMBER = re.compile(_WS + r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?)(\d+))?" + _WS + r"\Z")
_INT = re.compile(_WS + r"[+-]?\d+" + _WS + r"\Z")
# a column of these, each at most 15 characters (so at most 15 digits and a
# power of ten below 1e15, both exact: one rounding), parses as float() does
_SHORT_DECIMALS = re.compile(r"(?:[+-]?(?:\d+\.?\d*|\.\d+)\n)*")
_POW10 = tuple(float(f"1e{k}") for k in range(309))  # the C literals 1e0 … 1e308
_EXACT = 1 << 53
_MAX_DIGITS = 17


def parse_float(s: str) -> Optional[float]:
    """``s`` as pandas' C parser reads a number (``precise_xstrtod``), or
    None where it reads none."""
    m = _NUMBER.match(s)
    if m is None:
        return _INF.get(s.lower())
    sign, ip, fp, esign, ed = m.groups()
    fp = fp or ""
    digits = ip + fp
    if not digits:
        return None
    # integer digits past the 17th raise the exponent; fraction digits past
    # it are dropped
    exponent = max(len(ip) - _MAX_DIGITS, 0) - min(len(fp), max(_MAX_DIGITS - len(ip), 0))
    if ed:
        exponent += -int(ed) if esign == "-" else int(ed)
    kept = digits[:_MAX_DIGITS]
    v = int(kept)
    if v < _EXACT:
        number = float(v)
    else:  # the accumulation n * 10 + d rounds once past 2**53
        number = float(int(kept[:15]))
        for c in kept[15:]:
            number = number * 10.0 + (ord(c) - 48)
    if sign == "-":
        number = -number
    if exponent > 308:
        return number * float("inf") if number else 0.0
    if exponent >= 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(cells: list[str]) -> np.ndarray:
    """One column's cells -> a NumPy array typed as pandas types it."""
    if not cells:  # a header without rows
        return np.empty(0, object)
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, na in zip(cells, missing) if not na]
    if not present:
        return np.full(len(cells), np.nan)
    if all(_INT.match(c) for c in present):
        ints = [int(c) for c in present]
        if all(-(1 << 63) <= v < (1 << 63) for v in ints):
            if not any(missing):
                return np.asarray(ints, np.int64)
            out = np.full(len(cells), np.nan)
            out[~np.asarray(missing)] = ints
            return out
    if max(map(len, present)) <= 15 and _SHORT_DECIMALS.fullmatch("\n".join(present) + "\n"):
        floats = np.asarray(present, np.float64)
    else:
        floats = [parse_float(c) for c in present]
    if all(v is not None for v in floats):
        out = np.full(len(cells), np.nan)
        out[~np.asarray(missing)] = floats
        return out
    out = np.empty(len(cells), object)
    out[:] = [np.nan if na else c for c, na in zip(cells, missing)]
    return out


def _names(header: list[str]) -> list[str]:
    names, seen = [], {}
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        base, k = name, seen.get(name, 0)
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen[base] = k
        seen[name] = 0
        names.append(name)
    return names


class Table:
    """Named NumPy columns of equal length, in file order."""

    def __init__(self, columns: dict[str, np.ndarray]):
        self.data = dict(columns)
        self.columns = tuple(self.data)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __contains__(self, name) -> bool:
        return name in self.data

    def __getitem__(self, name: str) -> np.ndarray:
        return self.data[name]

    def take(self, rows: np.ndarray) -> "Table":
        """The rows selected by a boolean mask or an index array."""
        return Table({k: v[rows] for k, v in self.data.items()})


def read_csv(path: str | Path) -> Table:
    """A CSV file with a header row as a ``Table``; raises ``ValueError``
    on a file with no header or a row longer than the header."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    names = _names(rows[0])
    body = rows[1:]
    width = len(names)
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields in line {i + 2}, saw {len(r)}")
    cols = [[r[j] if j < len(r) else "" for r in body] for j in range(width)]
    return Table({n: _column(c) for n, c in zip(names, cols)})


def to_numeric(col: np.ndarray) -> np.ndarray:
    """float64 of a column, NaN where a text cell is not a number
    (``pd.to_numeric(errors="coerce")``)."""
    if col.dtype != object:
        return col.astype(np.float64)
    out = np.full(len(col), np.nan)
    for i, v in enumerate(col):
        x = parse_float(v) if isinstance(v, str) else None
        if x is not None:
            out[i] = x
    return out
