"""Dataset: a schema-carrying table held as a dict of numpy columns.

The JAX package keeps an arrow table (``models_tpu/data/dataset.py``); the port
needs no parquet IO, so a column is a numpy array and a list column is stored
the way ``table_to_numpy`` hands it to the loader: ``<name>__values`` (every
row's values, concatenated) and ``<name>__offsets`` (row starts, length n+1).

A string or bytes column stays as it is in the table, as the arrow table
keeps it, so that a preprocessing workflow (``data/workflow.py``) sees the
raw values; :meth:`Dataset.to_numpy_dict`, the loader's view, hands it out
hashed to int32 ids (``string_id_hash``), as the JAX package's
``table_to_numpy`` does. Where the JAX package returns an arrow table
(``head``, ``partitions``), the port returns its own :class:`Dataset`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..schema import ColumnSchema, Schema

VALUES, OFFSETS = "__values", "__offsets"


def _is_ragged(col) -> bool:
    return (
        isinstance(col, (list, np.ndarray))
        and len(col) > 0
        and (getattr(col, "dtype", None) == object or isinstance(col, list))
        and isinstance(col[0], (list, np.ndarray))
    )


def _hash_if_strings(arr: np.ndarray) -> np.ndarray:
    """A string or bytes column as int32 ids (``string_id_hash``, the JAX
    package's loader convention), so that raw string ids feed a
    dynamic-vocabulary table; other columns pass."""
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        from ..inputs.dynamic import string_id_hash

        return string_id_hash(arr)
    return arr


def _encode(data: Dict[str, object]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, col in data.items():
        if _is_ragged(col):
            rows = [np.asarray(r) for r in col]
            out[name + OFFSETS] = np.concatenate(
                [[0], np.cumsum([len(r) for r in rows])]
            ).astype(np.int64)
            values = np.concatenate(rows)
            if values.dtype == object:  # equal-length rows made a 2-D object array
                values = np.asarray(values.tolist())
            out[name + VALUES] = values
        else:
            out[name] = np.asarray(col)
    return out


def take_rows(cols: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    """Rows ``idx`` of encoded columns, ragged list columns included."""
    out: Dict[str, np.ndarray] = {}
    for name, col in cols.items():
        if name.endswith(VALUES):
            continue
        if name.endswith(OFFSETS):
            base = name[: -len(OFFSETS)]
            lengths = np.diff(col)[idx]
            new_offs = np.zeros(len(idx) + 1, dtype=np.int64)
            np.cumsum(lengths, out=new_offs[1:])
            shift = np.repeat(col[:-1][idx] - new_offs[:-1], lengths)
            out[base + VALUES] = cols[base + VALUES][np.arange(new_offs[-1]) + shift]
            out[name] = new_offs
        else:
            out[name] = col[idx]
    return out


class Dataset:
    """An in-memory table of numpy columns plus its :class:`Schema`."""

    def __init__(self, data: Dict[str, object], schema: Optional[Schema] = None):
        if isinstance(data, Dataset):
            schema = schema or data.schema
            data = data._cols
        self._cols = _encode(data)
        self._hashed: Optional[Dict[str, np.ndarray]] = None
        if schema is None:
            schema = Schema([ColumnSchema(n) for n in self.column_names])
        self.schema = schema

    @property
    def column_names(self) -> List[str]:
        names = []
        for n in self._cols:
            if n.endswith(VALUES):
                continue
            names.append(n[: -len(OFFSETS)] if n.endswith(OFFSETS) else n)
        return names

    @property
    def num_rows(self) -> int:
        for name, col in self._cols.items():
            if name.endswith(OFFSETS):
                return len(col) - 1
            if not name.endswith(VALUES):
                return len(col)
        return 0

    def __len__(self) -> int:
        return self.num_rows

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        """Every column; a list column as its ``__values``/``__offsets`` pair;
        string and bytes values hashed to int32 ids (computed once)."""
        if self._hashed is None:
            self._hashed = {k: _hash_if_strings(v) for k, v in self._cols.items()}
        return dict(self._hashed)

    def columns(self) -> Dict[str, object]:
        """Every column as the table holds it: strings as strings, a list
        column as an object array of per-row arrays (the JAX package's
        ``to_table()`` columns, read by ``Workflow``)."""
        out: Dict[str, object] = {}
        for name in self.column_names:
            if name + OFFSETS in self._cols:
                offs, vals = self._cols[name + OFFSETS], self._cols[name + VALUES]
                rows = np.empty(len(offs) - 1, dtype=object)
                rows[:] = [vals[a:b] for a, b in zip(offs[:-1], offs[1:])]
                out[name] = rows
            else:
                out[name] = self._cols[name]
        return out

    def _from_cols(self, cols: Dict[str, np.ndarray], schema: Optional[Schema] = None
                   ) -> "Dataset":
        ds = Dataset.__new__(Dataset)
        ds._cols, ds.schema, ds._hashed = cols, schema or self.schema, None
        return ds

    def with_columns(self, columns: Dict[str, np.ndarray]) -> "Dataset":
        """This dataset with ``columns`` added (or replaced), each an array
        of one row per row; the schema is kept."""
        cols = dict(self._cols)
        for name, col in columns.items():
            col = np.asarray(col)
            if len(col) != self.num_rows:
                raise ValueError(f"column {name!r} has {len(col)} rows, the dataset "
                                 f"{self.num_rows}")
            cols[name] = col
        return self._from_cols(cols)

    def take(self, n: int) -> "Dataset":
        return self._from_cols(take_rows(self._cols, np.arange(min(n, self.num_rows))))

    def head(self, n: int = 5) -> "Dataset":
        """The first ``n`` rows (the JAX package returns them as an arrow
        table; the port as a Dataset)."""
        return self.take(n)

    def shuffle(self, seed: int = 0) -> "Dataset":
        """The rows in one permutation drawn from ``seed`` (the JAX
        package's)."""
        idx = np.random.default_rng(seed).permutation(self.num_rows)
        return self._from_cols(take_rows(self._cols, idx))

    def select_columns(self, names: Sequence[str]) -> "Dataset":
        """The named columns, in that order, with the schema's columns of
        those names."""
        names = list(names)
        missing = [n for n in names if n not in self.column_names]
        if missing:
            raise KeyError(f"no columns {missing} in {self.column_names}")
        cols: Dict[str, np.ndarray] = {}
        for name in names:
            if name + OFFSETS in self._cols:
                cols[name + VALUES] = self._cols[name + VALUES]
                cols[name + OFFSETS] = self._cols[name + OFFSETS]
            else:
                cols[name] = self._cols[name]
        return self._from_cols(cols, self.schema.select_by_name(names))

    def partitions(self) -> Iterator["Dataset"]:
        """The table's parts: one, the whole in-memory table (the JAX
        package yields one arrow table a parquet file; the port holds no
        files)."""
        yield self

    def split(self, fractions: Sequence[float], seed: int = 0) -> List["Dataset"]:
        """Disjoint parts of ``round(fraction * rows)`` rows each, from one
        permutation drawn from ``seed`` (the JAX package's split)."""
        n = self.num_rows
        idx = np.random.default_rng(seed).permutation(n)
        out, start = [], 0
        for frac in fractions:
            count = int(round(frac * n))
            out.append(self._from_cols(take_rows(self._cols, idx[start:start + count])))
            start += count
        return out

    def unique_by(self, column: str) -> "Dataset":
        """Deduplicate rows by a column, keeping each value's FIRST row, in
        first-occurrence order (the catalog's item features depend on it)."""
        _, first_idx = np.unique(self._cols[column], return_index=True)
        return self._from_cols(take_rows(self._cols, np.sort(first_idx)))

    def __repr__(self):
        return f"Dataset(rows={self.num_rows}, cols={len(self.schema)})"
