"""Host-side preprocessing workflows (``models_tpu/data/workflow.py``): the
NVTabular-like ETL ops as fit/transform objects over (dict of numpy columns,
Schema), and the :class:`Workflow` that runs them in order.

    wf = Workflow([
        Categorify(["userId", "movieId"]),
        TargetEncoding("movieId", target="rating", kfold=5, p_smooth=20,
                       out="TE_movieId_rating", normalize=True, tags=Tags.ITEM),
        GroupbyCount("userId", log=True, out="userId_count", tags=Tags.USER),
        LambdaOp("rating", lambda v: (v > 3).astype("int32"),
                 out="rating_binary", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET)),
    ])
    train = wf.fit_transform(train)
    valid = wf.transform(valid)          # the fitted vocabularies and statistics

The JAX module is numpy only, and this is a copy of its functions:
``Categorify`` numbers the values by falling frequency (ties in sorted value
order), 1 the most frequent, 0 the unknown; ``TargetEncoding`` hands the
rows it was fitted on (told by a SHA-1 digest of their column) their
out-of-fold k-fold encoding, and any other rows the full mapping. A
:class:`Workflow` reads a :class:`~models_tpu_torch.data.dataset.Dataset`'s
columns as the table holds them (:meth:`Dataset.columns`: strings as
strings), as the JAX package reads its arrow table. It runs once per dataset
on the host, never on the card.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..schema import ColumnSchema, Domain, Schema, Tags
from .dataset import Dataset


TableLike = Dict[str, np.ndarray]


def _tags_tuple(tags) -> tuple:
    if tags is None:
        return ()
    if isinstance(tags, (list, tuple)):
        return tuple(tags)
    return (tags,)


class Op:
    """fit(data, schema) -> None; transform(data, schema) -> (data, schema)."""

    def fit(self, data: TableLike, schema: Schema) -> None:  # noqa: D401
        pass

    def transform(self, data: TableLike, schema: Schema) -> Tuple[TableLike, Schema]:
        raise NotImplementedError


class Categorify(Op):
    """Map raw categorical values to contiguous ids, frequency-ordered
    (id 1 = most frequent; 0 is reserved for unknown/OOV — the NVTabular
    convention, which also gives PopularityBasedSampler its frequency-sorted
    id contract up to the +1 shift).

    ``freq_threshold``: values seen fewer times map to 0. ``max_size``: cap
    the vocabulary (least-frequent overflow → 0), the reference's
    ``Categorify(max_size=...)``.
    """

    def __init__(self, columns: Sequence[str], freq_threshold: int = 0,
                 max_size: Optional[int] = None, out_dtype: str = "int32"):
        self.columns = list(columns)
        self.freq_threshold = freq_threshold
        self.max_size = max_size
        self.out_dtype = out_dtype
        self.vocabs: Dict[str, Dict] = {}

    def fit(self, data, schema):
        for col in self.columns:
            vals, counts = np.unique(np.asarray(data[col]), return_counts=True)
            order = np.argsort(-counts, kind="stable")
            vals, counts = vals[order], counts[order]
            if self.freq_threshold:
                keep = counts >= self.freq_threshold
                vals = vals[keep]
            if self.max_size is not None:
                vals = vals[: self.max_size - 1]  # slot 0 is OOV
            self.vocabs[col] = {v: i + 1 for i, v in enumerate(vals.tolist())}

    def transform(self, data, schema):
        data = dict(data)
        replaced = {}
        for col in self.columns:
            vocab = self.vocabs[col]
            raw = np.asarray(data[col])
            data[col] = np.asarray(
                [vocab.get(v, 0) for v in raw.tolist()], dtype=self.out_dtype
            )
            old = schema.get(col)
            tags = tuple(old.tags) if old is not None else ()
            if str(Tags.CATEGORICAL) not in [str(t) for t in tags]:
                tags = tags + (Tags.CATEGORICAL,)
            replaced[col] = ColumnSchema(
                col, tags=tags, dtype=self.out_dtype,
                int_domain=Domain(0, len(vocab), name=col, is_categorical=True),
            )
        cols = [replaced.get(c.name, c) for c in schema]
        cols += [c for name, c in replaced.items() if schema.get(name) is None]
        return data, Schema(cols)


class TargetEncoding(Op):
    """Out-of-fold target mean with additive smoothing (reference ml-25m
    workflow: ``ops.TargetEncoding(label, kfold=5, p_smooth=20)`` followed by
    ``Normalize``)."""

    def __init__(self, column: str, target: str, kfold: int = 5, p_smooth: float = 20.0,
                 out: Optional[str] = None, normalize: bool = True, tags=Tags.ITEM,
                 seed: int = 13):
        self.column = column
        self.target = target
        self.kfold = kfold
        self.p_smooth = p_smooth
        self.out = out or f"TE_{column}_{target}"
        self.normalize = normalize
        self.tags = _tags_tuple(tags)
        self.seed = seed
        self.mapping: Dict = {}
        self.global_mean = 0.0
        self.norm_mean = 0.0
        self.norm_std = 1.0

    def _encode(self, keys, sums, counts, global_mean):
        return (sums + self.p_smooth * global_mean) / (counts + self.p_smooth)

    def fit(self, data, schema):
        col = np.asarray(data[self.column])
        y = np.asarray(data[self.target], dtype=np.float64)
        self.global_mean = float(y.mean())
        keys, inv = np.unique(col, return_inverse=True)
        sums = np.bincount(inv, weights=y, minlength=len(keys))
        counts = np.bincount(inv, minlength=len(keys))
        enc = self._encode(keys, sums, counts, self.global_mean)
        self.mapping = dict(zip(keys.tolist(), enc.tolist()))
        # normalization stats from the OUT-OF-FOLD train encoding
        oof = self._oof(col, y, inv, keys, sums, counts)
        self.norm_mean = float(oof.mean())
        self.norm_std = float(oof.std() + 1e-9)
        self._fit_oof = oof
        # content fingerprint of the fitted column: transform() must hand the
        # OOF values to the *fitted rows themselves*, not to any split that
        # merely has the same row count (a same-sized valid split would get
        # the train's encodings verbatim — silent target leakage)
        self._fit_digest = hashlib.sha1(np.ascontiguousarray(col).tobytes()).digest()

    def _oof(self, col, y, inv, keys, sums, counts):
        """K-fold out-of-fold encoding of the training rows themselves (the
        value a fitted NVT TargetEncoding assigns in-sample)."""
        rng = np.random.default_rng(self.seed)
        folds = rng.integers(0, self.kfold, size=len(col))
        out = np.empty(len(col), np.float64)
        for f in range(self.kfold):
            m = folds == f
            f_sums = np.bincount(inv[m], weights=y[m], minlength=len(keys))
            f_counts = np.bincount(inv[m], minlength=len(keys))
            enc = self._encode(keys, sums - f_sums, counts - f_counts, self.global_mean)
            out[m] = enc[inv[m]]
        self._folds = folds
        return out

    def transform(self, data, schema):
        data = dict(data)
        col = np.asarray(data[self.column])
        if (
            getattr(self, "_fit_oof", None) is not None
            and len(col) == len(self._fit_oof)
            and hashlib.sha1(np.ascontiguousarray(col).tobytes()).digest()
            == self._fit_digest
        ):
            # the exact split this op was fitted on (sha1 of the raw column)
            # — serve the out-of-fold values EVERY time it comes back:
            # Workflow.fit() itself transforms the train split to feed
            # downstream ops, and the user's later wf.transform(train) must
            # get the same leak-free encodings, not the full-mapping ones
            vals = self._fit_oof
        else:
            vals = np.asarray(
                [self.mapping.get(v, self.global_mean) for v in col.tolist()]
            )
        if self.normalize:
            vals = (vals - self.norm_mean) / self.norm_std
        data[self.out] = vals.astype(np.float32)
        cols = list(schema) + [
            ColumnSchema(self.out, tags=self.tags + (Tags.CONTINUOUS,), dtype="float32")
        ]
        return data, Schema(cols)


class GroupbyCount(Op):
    """Per-key occurrence count feature (reference: ``JoinGroupby(stats=
    ['count']) >> LogOp``)."""

    def __init__(self, column: str, log: bool = True, out: Optional[str] = None,
                 tags=Tags.USER):
        self.column = column
        self.log = log
        self.out = out or f"{column}_count"
        self.tags = _tags_tuple(tags)
        self.counts: Dict = {}

    def fit(self, data, schema):
        keys, counts = np.unique(np.asarray(data[self.column]), return_counts=True)
        self.counts = dict(zip(keys.tolist(), counts.tolist()))

    def transform(self, data, schema):
        data = dict(data)
        col = np.asarray(data[self.column])
        vals = np.asarray([self.counts.get(v, 0) for v in col.tolist()], np.float32)
        if self.log:
            vals = np.log1p(vals)
        data[self.out] = vals
        cols = list(schema) + [
            ColumnSchema(self.out, tags=self.tags + (Tags.CONTINUOUS,), dtype="float32")
        ]
        return data, Schema(cols)


class Bucketize(Op):
    """Bin continuous values by explicit boundaries into bucket ids
    (reference ``ops.Bucketize(boundaries)``)."""

    def __init__(self, boundaries: Dict[str, Sequence[float]], tags=None):
        self.boundaries = {k: np.asarray(v, np.float64) for k, v in boundaries.items()}
        self.tags = _tags_tuple(tags)

    def transform(self, data, schema):
        data = dict(data)
        replaced = {}
        for col, bounds in self.boundaries.items():
            ids = np.digitize(np.asarray(data[col], np.float64), bounds).astype("int32")
            data[col] = ids
            old = schema.get(col)
            tags = (tuple(old.tags) if old is not None else ()) + self.tags
            replaced[col] = ColumnSchema(
                col, tags=tags + (Tags.CATEGORICAL,), dtype="int32",
                int_domain=Domain(0, len(bounds), name=col, is_categorical=True),
            )
        cols = [replaced.get(c.name, c) for c in schema]
        cols += [c for name, c in replaced.items() if schema.get(name) is None]
        return data, Schema(cols)


class Normalize(Op):
    """Standardize continuous columns with the fitted mean/std."""

    def __init__(self, columns: Sequence[str]):
        self.columns = list(columns)
        self.stats: Dict[str, Tuple[float, float]] = {}

    def fit(self, data, schema):
        for col in self.columns:
            v = np.asarray(data[col], np.float64)
            self.stats[col] = (float(v.mean()), float(v.std() + 1e-9))

    def transform(self, data, schema):
        data = dict(data)
        for col in self.columns:
            m, s = self.stats[col]
            data[col] = ((np.asarray(data[col], np.float64) - m) / s).astype(np.float32)
        return data, schema


class JoinExternal(Op):
    """Left-join an external table on a key column (reference
    ``ops.JoinExternal(movies, on=['movieId'])``)."""

    def __init__(self, table: TableLike, on: str, columns: Optional[Sequence[str]] = None,
                 fill: Union[int, float] = 0, tags=None):
        self.on = on
        self.fill = fill
        self.tags = _tags_tuple(tags)
        names = columns or [k for k in table if k != on]
        keys = np.asarray(table[on])
        self.tables = {
            name: dict(zip(keys.tolist(), np.asarray(table[name]).tolist()))
            for name in names
        }

    def transform(self, data, schema):
        data = dict(data)
        keys = np.asarray(data[self.on]).tolist()
        cols = list(schema)
        for name, mapping in self.tables.items():
            joined = [mapping.get(k, self.fill) for k in keys]
            arr = np.asarray(joined)
            data[name] = arr
            if np.issubdtype(arr.dtype, np.integer):
                cols.append(
                    ColumnSchema(
                        name, tags=self.tags + (Tags.CATEGORICAL,), dtype="int32",
                        int_domain=Domain(0, int(arr.max()), name=name, is_categorical=True),
                    )
                )
            else:
                cols.append(
                    ColumnSchema(name, tags=self.tags + (Tags.CONTINUOUS,), dtype="float32")
                )
        return data, Schema(cols)


class LambdaOp(Op):
    """Column function, optionally renamed + retagged (reference
    ``ops.LambdaOp`` + ``Rename`` + ``AddMetadata``)."""

    def __init__(self, column: str, fn: Callable[[np.ndarray], np.ndarray],
                 out: Optional[str] = None, tags=None, dtype: Optional[str] = None):
        self.column = column
        self.fn = fn
        self.out = out or column
        self.tags = _tags_tuple(tags)
        self.dtype = dtype

    def transform(self, data, schema):
        data = dict(data)
        arr = self.fn(np.asarray(data[self.column]))
        data[self.out] = arr
        dtype = self.dtype or str(arr.dtype)
        cols = [c for c in schema if c.name != self.out]
        old = next((c for c in schema if c.name == self.column), None)
        tags = self.tags or (tuple(old.tags) if old is not None and self.out == self.column else ())
        cols.append(ColumnSchema(self.out, tags=tags, dtype=dtype))
        return data, Schema(cols)


class AddTags(Op):
    """Attach tags to existing columns (reference ``AddMetadata`` /
    ``TagAsUserFeatures`` / ``TagAsItemFeatures``)."""

    def __init__(self, columns: Sequence[str], tags):
        self.columns = list(columns)
        self.tags = _tags_tuple(tags)

    def transform(self, data, schema):
        cols = []
        for c in schema:
            if c.name in self.columns:
                cols.append(c.with_tags(self.tags) if hasattr(c, "with_tags") else ColumnSchema(
                    c.name, tags=tuple(c.tags) + self.tags, dtype=c.dtype,
                    int_domain=c.int_domain, is_list=c.is_list,
                ))
            else:
                cols.append(c)
        return data, Schema(cols)


class FilterRows(Op):
    """Row filter by predicate over the column dict (reference ``ops.Filter``)."""

    def __init__(self, predicate: Callable[[TableLike], np.ndarray]):
        self.predicate = predicate

    def transform(self, data, schema):
        mask = np.asarray(self.predicate(data), bool)
        return {k: np.asarray(v)[mask] for k, v in data.items()}, schema


class Workflow:
    """Ordered ops with fitted state (the NVT ``Workflow`` contract:
    ``fit_transform(train)`` then ``transform(valid)``)."""

    def __init__(self, ops: Sequence[Op]):
        self.ops = list(ops)

    def _as_parts(self, dataset: Union[Dataset, TableLike]):
        if isinstance(dataset, Dataset):
            return dataset.columns(), dataset.schema
        raise TypeError(f"Workflow expects a Dataset, got {type(dataset)}")

    def fit(self, dataset: Dataset) -> "Workflow":
        data, schema = self._as_parts(dataset)
        for op in self.ops:
            op.fit(data, schema)
            data, schema = op.transform(data, schema)
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        data, schema = self._as_parts(dataset)
        for op in self.ops:
            data, schema = op.transform(data, schema)
        return Dataset(data, schema=schema)

    def fit_transform(self, dataset: Dataset) -> Dataset:
        data, schema = self._as_parts(dataset)
        for op in self.ops:
            op.fit(data, schema)
            data, schema = op.transform(data, schema)
        return Dataset(data, schema=schema)
