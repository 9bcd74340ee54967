"""Dataset: a schema-carrying table, in memory or in parquet files.

The JAX package keeps an arrow table or a list of parquet files
(``models_tpu/data/dataset.py``); the port keeps a dict of numpy columns or
a list of parquet files, which it reads and writes with its own codec
(``data/parquet.py``; no ``pyarrow``). A list column is stored the way
``table_to_numpy`` hands it to the loader: ``<name>__values`` (every row's
values, concatenated) and ``<name>__offsets`` (row starts, length n+1).

A string or bytes column stays as it is in the table, as the arrow table
keeps it, so that a preprocessing workflow (``data/workflow.py``) sees the
raw values; :meth:`Dataset.to_numpy_dict`, the loader's view, hands it out
hashed to int32 ids (``string_id_hash``), as the JAX package's
``table_to_numpy`` does. Where the JAX package returns an arrow table
(``head``, ``partitions``), the port returns its own :class:`Dataset`.

A dataset of files reads them when asked for rows, one file (partition) at a
time where it can, as the JAX package does: ``num_rows`` and
``column_names`` read the footers alone; the methods that return a new
dataset (``take``, ``shuffle``, ``split``, ``select_columns``, ``unique_by``,
``with_columns``) return one in memory. ``to_parquet`` writes
``part_{i}.parquet`` and the ``schema.json`` sidecar; ``Dataset(path)``
reads the sidecar (or ``schema.pbtxt``), else infers the schema from the
files as the JAX package's ``_infer_schema`` does.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..schema import ColumnSchema, Schema
from . import parquet
from .parquet import OFFSETS, VALUES

SCHEMA_FILE = "schema.json"
PBTXT_FILE = "schema.pbtxt"


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


def table_to_numpy(cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A table's columns as the loader takes them: strings hashed to int32
    ids (the JAX package's ``table_to_numpy`` of an arrow table)."""
    return {k: _hash_if_strings(v) for k, v in cols.items()}


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


def slice_rows(cols: Dict[str, np.ndarray], lo: int, hi: int) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of encoded columns (views where it can)."""
    out: Dict[str, np.ndarray] = {}
    for name, col in cols.items():
        if name.endswith(VALUES):
            continue
        if name.endswith(OFFSETS):
            base = name[: -len(OFFSETS)]
            v0, v1 = col[lo], col[hi]
            out[base + VALUES] = cols[base + VALUES][v0:v1]
            out[name] = col[lo:hi + 1] - v0
        else:
            out[name] = col[lo:hi]
    return out


def list_parquet_files(path: str) -> List[str]:
    """The ``*.parquet`` files of a directory, sorted, or the one file."""
    path = os.fspath(path)
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.parquet")))
        if not files:
            raise FileNotFoundError(f"No parquet files under {path}")
        return files
    return [path]


def infer_schema(columns: Sequence[parquet.Column]) -> Schema:
    """The JAX package's ``_infer_schema``: integers int64 or int32 by
    width, floats float32, the rest bytes; list-ness from the file."""
    out = []
    for col in columns:
        kind, bits = col.arrow_kind()
        dtype = ("int64" if bits == 64 else "int32") if kind == "int" else (
            "float32" if kind == "float" else "bytes")
        out.append(ColumnSchema(col.name, dtype=dtype, is_list=col.is_list,
                                is_ragged=col.is_list))
    return Schema(out)


class Dataset:
    """A table plus its :class:`Schema`: in memory (a dict of columns, or
    another Dataset) or parquet files (a file, a directory of them, or a
    list of files)."""

    def __init__(self, data: Union[Dict[str, object], str, os.PathLike, List[str], "Dataset"],
                 schema: Optional[Schema] = None):
        self._files: Optional[List[str]] = None
        self._cols: Optional[Dict[str, np.ndarray]] = None
        self._hashed: Optional[Dict[str, np.ndarray]] = None
        if isinstance(data, Dataset):
            schema = schema or data.schema
            self._files, self._cols = data._files, data._cols
        elif isinstance(data, dict):
            self._cols = _encode(data)
        elif isinstance(data, (str, os.PathLike)):
            path = os.fspath(data)
            self._files = list_parquet_files(path)
            if schema is None:
                base = path if os.path.isdir(path) else os.path.dirname(path)
                if os.path.exists(os.path.join(base, SCHEMA_FILE)):
                    schema = Schema.load(os.path.join(base, SCHEMA_FILE))
                elif os.path.exists(os.path.join(base, PBTXT_FILE)):
                    schema = Schema.load_pbtxt(os.path.join(base, PBTXT_FILE))
        elif isinstance(data, (list, tuple)):
            self._files = [os.fspath(f) for f in data]
        else:
            raise TypeError(f"Cannot build Dataset from {type(data)}")
        if schema is None:
            schema = (infer_schema(parquet.ParquetFile(self._files[0]).columns)
                      if self._files is not None
                      else Schema([ColumnSchema(n) for n in self.column_names]))
        self.schema = schema

    # ---- basic info --------------------------------------------------------
    @property
    def files(self) -> Optional[List[str]]:
        """The parquet files, or None for a dataset in memory."""
        return self._files

    @property
    def column_names(self) -> List[str]:
        if self._files is not None:
            return parquet.ParquetFile(self._files[0]).column_names
        return parquet.table_names(self._cols)

    @property
    def num_rows(self) -> int:
        if self._files is not None:
            return sum(parquet.ParquetFile(f).num_rows for f in self._files)
        return parquet.table_rows(self._cols)

    def __len__(self) -> int:
        return self.num_rows

    # ---- materialization ---------------------------------------------------
    def table(self) -> Dict[str, np.ndarray]:
        """Every column, strings as strings (a dataset of files reads them
        all)."""
        if self._files is None:
            return self._cols
        return parquet.concat_tables([parquet.read_table(f) for f in self._files])

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        """Every column; a list column as its ``__values``/``__offsets`` pair;
        string and bytes values hashed to int32 ids (computed once for a
        dataset in memory; a dataset of files reads and hashes anew)."""
        if self._files is not None:
            return table_to_numpy(self.table())
        return self.loader_columns(self.column_names)

    def loader_columns(self, names: Sequence[str]) -> Dict[str, np.ndarray]:
        """The named columns as :meth:`to_numpy_dict` gives them: of files,
        only these columns read; in memory, each column hashed once."""
        if self._files is not None:
            return table_to_numpy(parquet.concat_tables(
                [parquet.read_table(f, names) for f in self._files]))
        if self._hashed is None:
            self._hashed = {}
        out = {}
        for name in names:
            keys = [name + VALUES, name + OFFSETS] if name + OFFSETS in self._cols else [name]
            for key in keys:
                if key not in self._hashed:
                    self._hashed[key] = _hash_if_strings(self._cols[key])
                out[key] = self._hashed[key]
        return out

    def columns(self) -> Dict[str, object]:
        """Every column as the table holds it: strings as strings, a list
        column as an object array of per-row arrays (the JAX package's
        ``to_table()`` columns, read by ``Workflow``)."""
        cols = self.table()
        out: Dict[str, object] = {}
        for name in parquet.table_names(cols):
            if name + OFFSETS in cols:
                offs, vals = cols[name + OFFSETS], cols[name + VALUES]
                rows = np.empty(len(offs) - 1, dtype=object)
                rows[:] = [vals[a:b] for a, b in zip(offs[:-1], offs[1:])]
                out[name] = rows
            else:
                out[name] = cols[name]
        return out

    def partitions(self) -> Iterator["Dataset"]:
        """The table's parts: one a parquet file, read when its turn comes;
        a dataset in memory is one part (the JAX package yields arrow
        tables)."""
        if self._files is None:
            yield self
            return
        for f in self._files:
            yield self._from_cols(parquet.read_table(f))

    def _from_cols(self, cols: Dict[str, np.ndarray], schema: Optional[Schema] = None
                   ) -> "Dataset":
        ds = Dataset.__new__(Dataset)
        ds._files, ds._cols, ds._hashed = None, cols, None
        ds.schema = schema or self.schema
        return ds

    # ---- transforms --------------------------------------------------------
    def with_columns(self, columns: Dict[str, np.ndarray]) -> "Dataset":
        """This dataset with ``columns`` added (or replaced), each an array
        of one row per row; the schema is kept."""
        cols = dict(self.table())
        n = parquet.table_rows(cols)
        for name, col in columns.items():
            col = np.asarray(col)
            if len(col) != n:
                raise ValueError(f"column {name!r} has {len(col)} rows, the dataset {n}")
            cols[name] = col
        return self._from_cols(cols)

    def take(self, n: int) -> "Dataset":
        """The first ``n`` rows (of files: read until they are had)."""
        if self._files is None:
            return self._from_cols(slice_rows(self._cols, 0, min(n, self.num_rows)))
        parts, have = [], 0
        for f in self._files:
            pf = parquet.ParquetFile(f)
            for g in range(pf.num_row_groups):
                if have >= n:
                    break
                parts.append(pf.read_row_group(g))
                have += pf.row_group_rows(g)
        cols = parquet.concat_tables(parts) if parts else self.table()
        return self._from_cols(slice_rows(cols, 0, min(n, parquet.table_rows(cols))))

    def head(self, n: int = 5) -> "Dataset":
        """The first ``n`` rows (the JAX package returns them as an arrow
        table; the port as a Dataset)."""
        return self.take(n)

    def shuffle(self, seed: int = 0) -> "Dataset":
        """The rows in one permutation drawn from ``seed`` (the JAX
        package's)."""
        cols = self.table()
        idx = np.random.default_rng(seed).permutation(parquet.table_rows(cols))
        return self._from_cols(take_rows(cols, idx))

    def select_columns(self, names: Sequence[str]) -> "Dataset":
        """The named columns, in that order, with the schema's columns of
        those names (of files: only those columns are read)."""
        names = list(names)
        missing = [n for n in names if n not in self.column_names]
        if missing:
            raise KeyError(f"no columns {missing} in {self.column_names}")
        src = self._cols if self._files is None else parquet.concat_tables(
            [parquet.read_table(f, names) for f in self._files])
        cols: Dict[str, np.ndarray] = {}
        for name in names:
            if name + OFFSETS in src:
                cols[name + VALUES] = src[name + VALUES]
                cols[name + OFFSETS] = src[name + OFFSETS]
            else:
                cols[name] = src[name]
        return self._from_cols(cols, self.schema.select_by_name(names))

    def split(self, fractions: Sequence[float], seed: int = 0) -> List["Dataset"]:
        """Disjoint parts of ``round(fraction * rows)`` rows each, from one
        permutation drawn from ``seed`` (the JAX package's split)."""
        cols = self.table()
        n = parquet.table_rows(cols)
        idx = np.random.default_rng(seed).permutation(n)
        out, start = [], 0
        for frac in fractions:
            count = int(round(frac * n))
            out.append(self._from_cols(take_rows(cols, idx[start:start + count])))
            start += count
        return out

    def unique_by(self, column: str) -> "Dataset":
        """Deduplicate rows by a column, keeping each value's FIRST row, in
        first-occurrence order (the catalog's item features depend on it)."""
        cols = self.table()
        _, first_idx = np.unique(cols[column], return_index=True)
        return self._from_cols(take_rows(cols, np.sort(first_idx)))

    # ---- IO ----------------------------------------------------------------
    def to_parquet(self, path: str, row_group_size: Optional[int] = None,
                   num_partitions: int = 1) -> str:
        """Write the table as ``num_partitions`` files ``part_{i}.parquet``
        of equal row counts (the last the rest) under the directory
        ``path``, each in row groups of ``row_group_size`` rows, and the
        schema as ``schema.json`` beside them (the JAX package's layout).
        Returns ``path``."""
        os.makedirs(path, exist_ok=True)
        cols = self.table()
        n = parquet.table_rows(cols)
        parts = max(num_partitions, 1)
        per = -(-n // parts)
        for i in range(parts):
            lo, hi = i * per, min((i + 1) * per, n)
            if hi <= lo:
                break
            parquet.write_table(slice_rows(cols, lo, hi),
                                os.path.join(path, f"part_{i}.parquet"), row_group_size)
        self.schema.save(os.path.join(path, SCHEMA_FILE))
        return path

    @classmethod
    def from_parquet(cls, path: str, schema: Optional[Schema] = None) -> "Dataset":
        return cls(path, schema=schema)

    def __repr__(self):
        src = f"{len(self._files)} files" if self._files else "in-memory"
        return f"Dataset({src}, rows={self.num_rows}, cols={len(self.schema)})"
