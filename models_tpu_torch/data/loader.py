"""In-order batch loader over a :class:`Dataset` (the plain path of
``models_tpu/data/loader.py``).

Batches are always full-size: the final partial batch is zero-padded and the
boolean column ``__row_valid__`` marks its real rows. List columns leave as
:class:`SequenceFeature` (values padded to the schema's max length, plus mask).
Batches hold numpy arrays; ``core.types.to_device_batch`` moves them.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

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


class Loader:
    """Iterates ``(features, targets)`` batches over a dataset, in row order,
    or with ``shuffle`` in one permutation per pass, drawn from
    ``seed + epoch * 9973`` (the JAX loader's epoch seed; the pass counter
    starts at 1)."""

    def __init__(self, dataset: Dataset, batch_size: int, drop_last: bool = False,
                 shuffle: bool = False, seed: int = 0):
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
                padded, mask = pad_ragged(
                    cols[name + VALUES], cols[name + OFFSETS][lo : hi + 1], self._list_cols[name]
                )
                dest[name] = SequenceFeature(pad_rows(padded), pad_rows(mask))
            else:
                dest[name] = pad_rows(cols[name][lo:hi])
        valid = np.zeros(self.batch_size, dtype=bool)
        valid[: hi - lo] = True
        feats[ROW_VALID_KEY] = valid
        if len(targets) == 1:
            targets = next(iter(targets.values()))
        return feats, (targets if len(targets) else None)

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Optional[Any]]]:
        self._epoch += 1
        cols = self.dataset.to_numpy_dict()
        n = self.dataset.num_rows
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch * 9973)
            cols = take_rows(cols, rng.permutation(n))
        full = n // self.batch_size
        for step in range(full):
            lo = step * self.batch_size
            yield self._assemble(cols, lo, lo + self.batch_size)
        if n > full * self.batch_size and not self.drop_last:
            yield self._assemble(cols, full * self.batch_size, n)
