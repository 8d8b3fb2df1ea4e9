"""Featurized CSV reading and writing (the JAX package's ``data/csvio.py``).

Reading implements xgboost's DMatrix URI semantics
``?format=csv&label_column=k``: column k is split out as the label and
the remaining columns become features. Writing produces the fixed schema
(one header line, one row per line, integers without a decimal point), or
under ``compat=True`` the reference writer's bytes: its header with the
typos, no newline anywhere, and ``", "`` after every value. Both modes
are byte-identical to the JAX package's writer.

Reading takes the native library's threaded parser (utils/native_lib.py)
when it is built, with the Python parser's rules: the header is the
first non-blank line, and any native failure falls back to the Python
parse, so errors keep their precise messages. The two agree bit for bit
on what this writer writes (integers and ``repr`` of floats); strtof
rounds a decimal to float32 once where the Python parse rounds it to
float64 first, which can differ only for a decimal within a float64 ulp
of a float32 rounding midpoint.
"""

from __future__ import annotations

import numpy as np

from euromillioner_tpu_torch.config import FIXED_CSV_HEADER, REFERENCE_CSV_HEADER
from euromillioner_tpu_torch.utils.errors import DataError


def _format_value(v: float) -> str:
    """Integers print without a decimal point; other values round-trip
    exactly (repr)."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def write_csv(path: str, rows, *, header: str | None = None,
              compat: bool = False) -> None:
    """Write featurized rows to ``path``: the fixed schema, or with
    ``compat=True`` the reference writer's bytes (see the module note)."""
    with open(path, "w", encoding="utf-8") as fh:
        if compat:
            fh.write(header if header is not None else REFERENCE_CSV_HEADER)
            for row in rows:
                fh.write("".join(f"{_format_value(v)}, " for v in row))
        else:
            fh.write((header if header is not None else FIXED_CSV_HEADER)
                     + "\n")
            for row in rows:
                fh.write(",".join(_format_value(v) for v in row) + "\n")


def split_label(data: np.ndarray, names: list[str], label_column: int
                ) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Split column ``label_column`` out of ``data`` (xgboost
    ``?label_column=k``) — used by CSV reading and ``Dataset.from_rows``."""
    if not (0 <= label_column < data.shape[1]):
        raise DataError(
            f"label_column={label_column} out of range for {data.shape[1]} columns")
    labels = data[:, label_column].copy()
    feats = np.delete(data, label_column, axis=1)
    if names:
        names = names[:label_column] + names[label_column + 1:]
    return feats, labels, names


def _read_csv_native(path: str, has_header: bool):
    """(data, names) via libemtpu, or (None, []) when it is unavailable or
    its parse fails."""
    from euromillioner_tpu_torch.utils import native_lib

    lib = native_lib.get()
    if lib is None:
        return None, []
    try:
        blob = lib.read_file(path)
        names: list[str] = []
        if has_header:
            # the first NON-BLANK line: the native parser skips blank
            # lines, so the header is found the same way
            head = next((ln for ln in blob.split(b"\n") if ln.strip()), b"")
            head_s = head.decode("utf-8", errors="replace")
            names = [c.strip() for c in head_s.split(",") if c.strip()]
        return lib.parse_csv(blob, has_header), names
    except (OSError, ValueError):
        return None, []


def _parse_row(ln: str, path: str) -> list[float]:
    cells = [c.strip() for c in ln.split(",")]
    if cells and cells[-1] == "":
        cells = cells[:-1]  # tolerate a trailing comma
    try:
        return [float(c) for c in cells]
    except ValueError as e:
        raise DataError(f"malformed CSV row in {path}: {e}") from e


def read_csv(path: str, *, label_column: int | None = 0,
             has_header: bool = True
             ) -> tuple[np.ndarray, np.ndarray | None, list[str]]:
    """A fixed-schema CSV → ``(features, labels, feature_names)`` float32;
    ``label_column=None`` returns every column as a feature and no
    labels. Blank lines are skipped. The native parser runs first when
    the library is built; its failure falls back to the Python parse."""
    data, names = _read_csv_native(path, has_header)
    if data is not None:
        if label_column is None:
            return data, None, names
        return split_label(data, names, label_column)
    with open(path, "r", encoding="utf-8") as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    if not lines:
        raise DataError(f"empty CSV file: {path}")
    names: list[str] = []
    if has_header:
        names = [c.strip() for c in lines[0].split(",") if c.strip()]
        lines = lines[1:]
    rows = [_parse_row(ln, path) for ln in lines]
    widths = {len(r) for r in rows}
    if len(widths) > 1:
        raise DataError(f"ragged CSV rows in {path}: widths {sorted(widths)}")
    data = np.array(rows, dtype=np.float32)
    if data.ndim != 2:
        raise DataError(f"ragged CSV rows in {path}")
    if label_column is None:
        return data, None, names
    return split_label(data, names, label_column)
