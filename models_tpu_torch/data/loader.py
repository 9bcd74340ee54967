"""In-order batch loader over a :class:`Dataset` (the plain path of
``models_tpu/data/loader.py``).

Batches are always full-size: the final partial batch is zero-padded and the
boolean column ``__row_valid__`` marks its real rows. List columns leave as
:class:`SequenceFeature`, values plus mask, padded to the schema's max length
(``pad="max"``) or, with ``pad="bucket"``, to the batch's longest row rounded
up to a power of two and capped at that max. Batches hold numpy arrays;
``core.types.to_device_batch`` moves them.

``global_size`` / ``global_rank`` give each of a run's processes its own
rows (``parallel.local_loader_kwargs()``), as the JAX loader does: every
process draws the same permutation (or keeps row order) and takes every
``global_size``-th row of it from ``global_rank`` on. Under ``pad="bucket"``
they agree on each step's bucket from the permutation of all rows, so that
every process's batch of a step has the same shape.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.types import SequenceFeature
from .dataset import OFFSETS, VALUES, Dataset, take_rows

ROW_VALID_KEY = "__row_valid__"


def pad_ragged(values: np.ndarray, offsets: np.ndarray, max_len: int):
    """Ragged rows -> (padded (n, max_len) values, mask). Rows are cut at
    ``max_len``; padded positions hold 0."""
    lengths = np.diff(offsets)
    pos = np.arange(max_len)[None, :]
    mask = pos < np.minimum(lengths, max_len)[:, None]
    if len(values) == 0:
        return np.zeros((len(lengths), max_len), dtype=values.dtype), mask
    idx = np.minimum(offsets[:-1, None] + pos, len(values) - 1)
    padded = np.where(mask, values[idx], np.zeros((), dtype=values.dtype))
    return padded, mask


def _bucket(n: int) -> int:
    """The power of two at or above ``n`` (1 for ``n`` <= 1)."""
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


class Loader:
    """Iterates ``(features, targets)`` batches over a dataset, in row order,
    or with ``shuffle`` in one permutation per pass, drawn from
    ``seed + epoch * 9973`` (the JAX loader's epoch seed; the pass counter
    starts at 1). ``pad``: ``"max"`` or ``"bucket"`` (the module's note)."""

    def __init__(self, dataset: Dataset, batch_size: int, drop_last: bool = False,
                 shuffle: bool = False, seed: int = 0, pad: str = "max", global_size: int = 1,
                 global_rank: int = 0):
        if pad not in ("max", "bucket"):
            raise ValueError(f"pad must be 'max' or 'bucket', got {pad!r}")
        if not 0 <= global_rank < global_size:
            raise ValueError(f"global_rank={global_rank} outside [0, global_size={global_size})")
        self.pad = pad
        self.global_size = int(global_size)
        self.global_rank = int(global_rank)
        self._bucket_plan: Optional[Dict[str, np.ndarray]] = None
        self.dataset = dataset
        self.schema = dataset.schema
        self.batch_size = int(batch_size)
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = int(seed)
        self._epoch = 0
        self._target_cols = [c.name for c in self.schema.targets]
        # bytes columns (movielens `title`) stay in the schema but are no input
        self._feature_cols = [
            c.name for c in self.schema
            if c.name not in self._target_cols and c.dtype != "bytes"
        ]
        self._list_cols = {c.name: max(c.max_seq_length, 1) for c in self.schema if c.is_list}

    def __len__(self) -> int:
        n = self.dataset.num_rows
        if self.global_size > 1:
            n //= self.global_size
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _assemble(self, cols: Dict[str, np.ndarray], lo: int, hi: int):
        feats: Dict[str, Any] = {}
        targets: Dict[str, Any] = {}
        pad = self.batch_size - (hi - lo)

        def pad_rows(arr):
            return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1)) if pad else arr

        for name in self._feature_cols + self._target_cols:
            dest = targets if name in self._target_cols else feats
            if name in self._list_cols:
                offsets = cols[name + OFFSETS][lo : hi + 1]
                L = self._list_cols[name]
                plan = self._bucket_plan
                if self.pad == "bucket" and plan is not None and name in plan:
                    step = lo // self.batch_size
                    L = int(plan[name][min(step, len(plan[name]) - 1)])
                elif self.pad == "bucket":
                    L = min(L, _bucket(int(np.diff(offsets).max()) if hi > lo else 1))
                padded, mask = pad_ragged(cols[name + VALUES], offsets, L)
                dest[name] = SequenceFeature(pad_rows(padded), pad_rows(mask))
            else:
                dest[name] = pad_rows(cols[name][lo:hi])
        valid = np.zeros(self.batch_size, dtype=bool)
        valid[: hi - lo] = True
        feats[ROW_VALID_KEY] = valid
        if len(targets) == 1:
            targets = next(iter(targets.values()))
        return feats, (targets if len(targets) else None)

    def dense_columns(self):
        """The whole dataset's assembled columns for the device-resident
        training route: ``(features, targets, n_rows)``, unshuffled, list
        columns padded to (n, L) values plus mask as
        :class:`SequenceFeature`, no ``__row_valid__`` (the route keeps only
        full batches). The engine uploads them to the device once and
        gathers each chunk's rows there. Raises ``ValueError`` for data it
        cannot hold so: a dataset of no rows."""
        if self.global_size > 1:
            raise ValueError("dense_columns() takes the whole dataset: not with global_size")
        cols = self.dataset.to_numpy_dict()
        n = self.dataset.num_rows
        if n == 0:
            raise ValueError("dense_columns() needs a dataset with rows")
        feats: Dict[str, Any] = {}
        targets: Dict[str, Any] = {}
        for name in self._feature_cols + self._target_cols:
            dest = targets if name in self._target_cols else feats
            if name in self._list_cols:
                padded, mask = pad_ragged(cols[name + VALUES], cols[name + OFFSETS],
                                          self._list_cols[name])
                dest[name] = SequenceFeature(padded, mask)
            else:
                dest[name] = cols[name]
        if len(targets) == 1:
            targets = next(iter(targets.values()))
        return feats, (targets if len(targets) else None), n

    def bucketed_dense_columns(self) -> List[Tuple[int, Dict[str, Any], Any, int]]:
        """The whole dataset's columns grouped by length bucket, for the
        device-resident route under ``pad="bucket"``: each row's bucket is the
        power of two at or above its longest list (each list cut at its
        column's max), and each group's list columns are padded to
        min(bucket, the column's max), so that batches taken within a group
        share one shape. ``[(bucket, features, targets, n_rows), ...]`` by
        bucket, each group's rows in dataset order, no ``__row_valid__``."""
        if not self._list_cols or self.global_size > 1:
            raise ValueError("bucketed_dense_columns needs list columns and the whole dataset")
        cols = self.dataset.to_numpy_dict()
        row_max = None
        for name, L in self._list_cols.items():
            n = np.minimum(np.diff(cols[name + OFFSETS]), L)
            row_max = n if row_max is None else np.maximum(row_max, n)
        buckets = 1 << np.ceil(np.log2(np.maximum(row_max, 1))).astype(np.int64)
        groups = []
        for bucket in np.unique(buckets):
            idx = np.nonzero(buckets == bucket)[0]
            rows = take_rows(cols, idx)
            feats: Dict[str, Any] = {}
            targets: Dict[str, Any] = {}
            for name in self._feature_cols + self._target_cols:
                dest = targets if name in self._target_cols else feats
                if name in self._list_cols:
                    L = min(self._list_cols[name], int(bucket))
                    dest[name] = SequenceFeature(*pad_ragged(rows[name + VALUES],
                                                             rows[name + OFFSETS], L))
                else:
                    dest[name] = rows[name]
            if len(targets) == 1:
                targets = next(iter(targets.values()))
            groups.append((int(bucket), feats, targets if len(targets) else None, len(idx)))
        return groups

    def _plan_buckets(self, cols, idx: np.ndarray) -> Optional[Dict[str, np.ndarray]]:
        """Each list column's pad length for each step, agreed by every
        process: global step s covers ``idx[s * B * S:(s + 1) * B * S]``
        (the strided rows of every process's batch s), padded to the power of
        two at or above its longest list, capped at the column's max."""
        if not self._list_cols:
            return None
        B, S = self.batch_size, self.global_size
        n_steps = -(-len(idx) // (B * S))
        plan = {}
        for name, L in self._list_cols.items():
            lengths = np.diff(cols[name + OFFSETS])[idx]
            padded = np.concatenate([lengths, np.zeros(n_steps * B * S - len(idx),
                                                        lengths.dtype)])
            per_step = padded.reshape(n_steps, B * S).max(axis=1)
            buckets = 1 << np.ceil(np.log2(np.maximum(per_step, 1))).astype(np.int64)
            plan[name] = np.minimum(np.maximum(buckets, 1), L)
        return plan

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Optional[Any]]]:
        self._epoch += 1
        cols = self.dataset.to_numpy_dict()
        n = self.dataset.num_rows
        idx = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch * 9973)
            idx = rng.permutation(n)
        if self.global_size > 1:
            idx = np.arange(n) if idx is None else idx
            self._bucket_plan = self._plan_buckets(cols, idx) if self.pad == "bucket" else None
            idx = idx[self.global_rank::self.global_size]
            n = len(idx)
        if idx is not None:
            cols = take_rows(cols, idx)
        full = n // self.batch_size
        for step in range(full):
            lo = step * self.batch_size
            yield self._assemble(cols, lo, lo + self.batch_size)
        if n > full * self.batch_size and not self.drop_last:
            yield self._assemble(cols, full * self.batch_size, n)
