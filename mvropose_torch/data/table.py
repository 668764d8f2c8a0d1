"""CSV tables without pandas: what the data path does with a DataFrame.

The reference reads its synced CSVs with pandas (`mvropose_tpu/cli/main.py:589`,
`data/builders.py`, `data/grouping.py`), which the card's machine does not
have. `Table` holds a CSV's columns as numpy arrays and gives the same values
for what the builders and the grouping ask of a DataFrame:

  * `read_csv(path)` and `concat(tables)` (`pd.concat([...], ignore_index=True)`:
    columns in order of appearance, a column one table lacks reads as NaN);
  * `Table.from_records(dicts)` (`pd.DataFrame(records)`) and
    `to_csv(path)`, which writes the bytes of pandas' `to_csv(path,
    index=False)`: ints as they are, float64 as their shortest repr, NaN as
    an empty field, fields quoted only where they must be;
  * column types as pandas' C parser infers them: int64 where every value is
    an integer and none is missing, float64 where every value is a number or
    missing, else strings (object, missing values NaN);
  * floats parsed as pandas parses them (`parse_float`, its `precise_xstrtod`,
    which differs from Python's correctly rounded `float` by an ulp on many
    9- and 17-digit values);
  * `table["col"]` (a numpy array: `.astype(str).tolist()` as the reference
    calls it), `table[[cols]].to_numpy(dtype)`, `table.columns`, `len`,
    `empty`, `take(rows)` (`.iloc[rows]`), and `sort_values(col)` (pandas'
    unstable quicksort order with NaN last, which sets the order of tied
    timestamps).
"""

from __future__ import annotations

import csv
import re
from pathlib import Path
from typing import Iterable, Mapping, Sequence

import numpy as np

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES).
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?\d+")
_FLOAT = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*")
_INF = {"inf": np.inf, "+inf": np.inf, "infinity": np.inf, "+infinity": np.inf,
        "-inf": -np.inf, "-infinity": -np.inf}
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17


def parse_float(s: str) -> float | None:
    """`s` as pandas' C parser reads it (`precise_xstrtod`): up to 17
    significant digits accumulated in a double (d = d * 10 + digit), then one
    multiplication or division by a power of ten; None where `s` is no
    number."""
    m = _FLOAT.fullmatch(s)
    if m is None or not (m.group(2) or m.group(3)):
        return _INF.get(s.strip().lower())
    sign, whole, frac, exp = m.groups()
    frac = frac or ""
    # The first 17 digits count, leading zeros included: whole digits past
    # them scale by ten, fraction digits past them are dropped.
    n_whole = min(len(whole), _MAX_DIGITS)
    n_frac = min(len(frac), _MAX_DIGITS - n_whole)
    digits = whole[:n_whole] + frac[:n_frac]
    exponent = len(whole) - n_whole - n_frac + int(exp or 0)
    value = int(digits or "0")
    if value < 2**53:  # every step of the accumulation is exact
        number = float(value)
    else:
        number = 0.0
        for d in digits:
            number = number * 10.0 + (ord(d) - 48)
    if sign == "-":
        number = -number
    if exponent > 308:
        return float("inf") if number > 0 else -float("inf") if number < 0 else 0.0
    if exponent >= 0:
        return number * _POW10[exponent] if exponent else number
    if exponent < -308:
        return 0.0 if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _infer(values: Sequence[str]) -> np.ndarray:
    """One column's strings -> int64, float64 or object, as pandas infers."""
    missing = [v in NA_VALUES for v in values]
    present = [v for v, na in zip(values, missing) if not na]
    if present and not any(missing) and all(_INT.fullmatch(v) for v in present):
        return np.array([int(v) for v in values], np.int64)
    floats = [np.nan if na else parse_float(v) for v, na in zip(values, missing)]
    if all(f is not None for f in floats):
        return np.array(floats, np.float64)
    return np.array([np.nan if na else v for v, na in zip(values, missing)], dtype=object)


def _column(values: Sequence) -> np.ndarray:
    """One column of Python values -> int64, float64 or object, as
    `pd.DataFrame(records)` types it; None and NaN are missing."""
    missing = [v is None or (isinstance(v, float) and v != v) for v in values]
    present = [v for v, na in zip(values, missing) if not na]
    numbers = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in present)
    if (numbers and present and not any(missing)
            and all(isinstance(v, (int, np.integer)) for v in present)):
        return np.array(values, np.int64)
    if numbers:
        return np.array([np.nan if na else float(v) for v, na in zip(values, missing)],
                        np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = [np.nan if na else v for v, na in zip(values, missing)]
    return out


def _csv_fields(values: np.ndarray) -> list:
    """A column as pandas' `to_csv` writes its fields."""
    if values.dtype.kind == "f":
        # float64 as Python's repr (the shortest that reads back), narrower
        # floats as numpy's shortest of their own type.
        fmt = (lambda v: repr(float(v))) if values.dtype == np.float64 else str
        return ["" if v != v else fmt(v) for v in values]
    if values.dtype.kind == "O":
        return ["" if v is None or (isinstance(v, float) and v != v) else str(v)
                for v in values]
    return [str(v) for v in values.tolist()]


class Table:
    """Named numpy columns of equal length, in order."""

    def __init__(self, columns: Mapping[str, np.ndarray] | None = None):
        self._cols = {k: np.asarray(v) for k, v in (columns or {}).items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length {sorted(lengths)}")
        self._len = lengths.pop() if lengths else 0

    @classmethod
    def from_records(cls, records: Sequence[Mapping]) -> "Table":
        """`pd.DataFrame(records)`: columns in order of first appearance, a
        key a record lacks is NaN there, types as `_column`."""
        names = list(dict.fromkeys(k for r in records for k in r))
        return cls({k: _column([r.get(k) for r in records]) for k in names})

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._len

    @property
    def empty(self) -> bool:
        return self._len == 0 or not self._cols

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, key):
        """A column's array, or a Table of a list of columns."""
        if isinstance(key, str):
            return self._cols[key]
        return Table({k: self._cols[k] for k in key})

    def __setitem__(self, name: str, values) -> None:
        values = np.asarray(values)
        if self._cols and len(values) != self._len:
            raise ValueError(f"column {name!r} has {len(values)} rows, the table {self._len}")
        self._len = len(values)
        self._cols[name] = values

    def to_numpy(self, dtype=None) -> np.ndarray:
        """(rows, columns) array, each column cast to `dtype`."""
        if not self._cols:
            return np.zeros((self._len, 0), dtype or np.float64)
        return np.stack([np.asarray(v).astype(dtype) if dtype is not None else v
                         for v in self._cols.values()], axis=1)

    def take(self, rows) -> "Table":
        """The rows at integer positions `rows`, in that order (`.iloc`)."""
        rows = np.asarray(rows, np.int64)
        return Table({k: v[rows] for k, v in self._cols.items()})

    def to_csv(self, path: str | Path) -> None:
        """Write the table as pandas' `to_csv(path, index=False)` does, byte
        for byte: the header, then the rows; a table without columns is one
        empty line."""
        with open(path, "w", newline="") as f:
            if not self._cols:
                f.write("\n")
                return
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(self.columns)
            writer.writerows(zip(*(_csv_fields(v) for v in self._cols.values())))

    def sort_values(self, name: str) -> "Table":
        """Rows ordered by column `name` as pandas' `sort_values(name,
        ignore_index=True)` orders them: numpy's (unstable) quicksort of the
        non-NaN values, then the NaN rows in their order."""
        values = self._cols[name]
        nan = np.isnan(values.astype(np.float64)) if values.dtype.kind in "fc" else np.zeros(
            len(values), bool)
        idx = np.arange(len(values))
        order = np.concatenate([idx[~nan][values[~nan].argsort(kind="quicksort")], idx[nan]])
        return Table({k: v[order] for k, v in self._cols.items()})


def read_csv(path: str | Path) -> Table:
    """A CSV file with a header row -> Table (types as `_infer`)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return Table()
    header, body = rows[0], rows[1:]
    width = len(header)
    body = [(r + [""] * width)[:width] for r in body]
    return Table({name: _infer([r[i] for r in body]) for i, name in enumerate(header)})


def concat(tables: Iterable[Table]) -> Table:
    """Rows of every table in turn, columns in order of first appearance; a
    column a table lacks is NaN there, so an int64 column with such a gap
    becomes float64 and any string column makes it object."""
    tables = list(tables)
    names: list[str] = []
    for t in tables:
        names += [c for c in t.columns if c not in names]
    out = {}
    for name in names:
        parts = [t[name] if name in t else np.full(len(t), np.nan) for t in tables]
        kinds = {p.dtype.kind for p in parts}
        if "O" in kinds:
            out[name] = np.concatenate([p.astype(object) for p in parts])
        elif kinds == {"i"}:
            out[name] = np.concatenate(parts).astype(np.int64)
        else:
            out[name] = np.concatenate([p.astype(np.float64) for p in parts])
    return Table(out)
