"""Per-sample metric rows -> CSV (the JAX package's `utils/csv_saver.py`),
on the stdlib `csv` module.

The file is the one `pandas.DataFrame(rows).to_csv(path)` writes: a leading
index column with an empty header, the columns in order of first
appearance, floats as `repr` writes them, and a missing or NaN value as an
empty cell.
"""

import csv
import math
import numbers


def _column_kind(values) -> str:
    """'int' for a column of integers with none missing, 'float' for a
    numeric column (with missing values), else 'object'."""
    present = [v for v in values if v is not None]
    numeric = all(isinstance(v, numbers.Real) and not isinstance(v, bool) for v in present)
    if numeric and present and len(present) == len(values) \
            and all(isinstance(v, numbers.Integral) for v in present):
        return "int"
    return "float" if numeric and present else "object"


def _cell(value, kind: str) -> str:
    if value is None:
        return ""
    if kind == "float":
        value = float(value)
        return "" if math.isnan(value) else repr(value)
    if kind == "int":
        return str(int(value))
    return str(value)


class Saver:

    def __init__(self) -> None:
        self.rows = []

    def add(self, row: dict) -> None:
        self.rows.append(dict(row))

    def write(self, path) -> None:
        columns = list(dict.fromkeys(k for row in self.rows for k in row))
        kinds = {c: _column_kind([row.get(c) for row in self.rows]) for c in columns}
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow([""] + columns)
            for i, row in enumerate(self.rows):
                writer.writerow([i] + [_cell(row.get(c), kinds[c]) for c in columns])
