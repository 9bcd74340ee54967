"""Host batch loader: a dataset (in memory or parquet files) -> padded numpy
batches (``models_tpu/data/loader.py``).

Batches are always full-size: the final partial batch is zero-padded and the
boolean column ``__row_valid__`` marks its real rows. List columns leave as
:class:`SequenceFeature`, values plus mask, padded to the schema's max length
(``pad="max"``) or, with ``pad="bucket"``, to the batch's longest row rounded
up to a power of two and capped at that max, through the native batcher
(``data/native.py::pad_ragged``, C++). Batches hold numpy arrays;
``core.types.to_device_batch`` moves them.

A dataset of more than one parquet chunk (a row group of a file) streams:
one chunk decoded at a time, its rows (and, with ``shuffle``, the chunk
order) permuted each epoch, the rows left over at a chunk's end carried into
the next so that batches stay full. Otherwise the whole table is decoded and
permuted at once. Decoded columns are kept in a RAM cache (``cache``, up to
``cache_limit_bytes``: the whole table, or one entry a chunk), so that later
epochs skip the decode. With ``prefetch`` > 0 the batches are assembled on a
thread, at most ``prefetch`` ahead of the consumer.

``global_size`` / ``global_rank`` give each of a run's processes its own
rows (``parallel.local_loader_kwargs()``), as the JAX loader does: every
process draws the same permutation (or keeps row order) and takes every
``global_size``-th row of it from ``global_rank`` on; a streamed dataset
gives each process every ``global_size``-th chunk instead. Under
``pad="bucket"`` they agree on each step's bucket from the permutation of
all rows, so that every process's batch of a step has the same shape; the
streamed route has no such view and refuses the combination.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from ..core.types import SequenceFeature
from ..schema import Schema
from . import native, parquet
from .dataset import OFFSETS, VALUES, Dataset, table_to_numpy, take_rows

ROW_VALID_KEY = "__row_valid__"

pad_ragged = native.plain_pad_ragged  # the batcher's plain version (numpy)


def _bucket(n: int) -> int:
    """The power of two at or above ``n`` (1 for ``n`` <= 1)."""
    return 1 << max(0, int(np.ceil(np.log2(max(n, 1)))))


def _collapse(targets: Optional[Dict[str, Any]]):
    """One target as itself, several as a dict, none as None."""
    if targets is None or not len(targets):
        return None
    if len(targets) == 1:
        return next(iter(targets.values()))
    return targets


class Loader:
    """Iterates ``(features, targets)`` batches over a dataset (or a path of
    parquet files), in row order or, with ``shuffle``, in one permutation a
    pass, drawn from :meth:`epoch_seed` (``seed + epoch * 9973``; the pass
    counter starts at 1). ``drop_last`` defaults to ``shuffle``, as the JAX
    loader's does. ``transform(features, targets)`` rewrites each host
    batch. ``schema`` replaces the dataset's. ``pad``: ``"max"`` or
    ``"bucket"`` (the module's note); ``cache``: ``"auto"`` or True keep
    decoded columns up to ``cache_limit_bytes``, False never."""

    def __init__(self, dataset: Union[Dataset, str], batch_size: int, shuffle: bool = False,
                 drop_last: Optional[bool] = None, seed: int = 0, global_size: int = 1,
                 global_rank: int = 0, transform=None, prefetch: int = 2,
                 schema: Optional[Schema] = None, cache: Union[bool, str] = "auto",
                 cache_limit_bytes: int = 4 << 30, pad: str = "max"):
        if pad not in ("max", "bucket"):
            raise ValueError(f"pad must be 'max' or 'bucket', got {pad!r}")
        if not 0 <= global_rank < global_size:
            raise ValueError(f"global_rank={global_rank} outside [0, global_size={global_size})")
        if not isinstance(dataset, Dataset):
            dataset = Dataset(dataset)
        self.dataset = dataset
        self.schema = schema or dataset.schema
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        self.seed = int(seed)
        self.global_size = int(global_size)
        self.global_rank = int(global_rank)
        self.transform = transform
        self.prefetch = prefetch
        self.pad = pad
        self._epoch = 0
        self._bucket_plan: Optional[Dict[str, np.ndarray]] = None
        self._cache_mode = cache
        self._cache_limit = int(cache_limit_bytes)
        self._cache_bytes = 0
        self._col_cache: Optional[Dict[str, np.ndarray]] = None
        self._file_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._chunks: Optional[List[Tuple[str, int]]] = None
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

    @property
    def output_schema(self) -> Schema:
        return self.schema

    def epoch_seed(self) -> int:
        """The seed of this pass's permutation, the same on every process."""
        return self.seed + self._epoch * 9973

    # ------------------------------------------------------------------
    # decoded columns and the RAM cache
    # ------------------------------------------------------------------
    def _cache_add(self, key: Optional[int], cols: Dict[str, np.ndarray]) -> None:
        if self._cache_mode is False:
            return
        nbytes = sum(a.nbytes for a in cols.values())
        if self._cache_bytes + nbytes > self._cache_limit:
            return
        self._cache_bytes += nbytes
        if key is None:
            self._col_cache = cols
        else:
            self._file_cache[key] = cols

    def _names(self) -> List[str]:
        return self._feature_cols + self._target_cols

    def _whole(self) -> Dict[str, np.ndarray]:
        """The loader's columns of the whole table, decoded (cached). Only
        they are read from files and hashed (a string column the model
        does not take costs nothing)."""
        cols = self._col_cache
        if cols is None:
            cols = self.dataset.loader_columns(self._names())
            self._cache_add(None, cols)
        return cols

    def _chunk_list(self) -> Optional[List[Tuple[str, int]]]:
        """The files' chunks as (file, row group) pairs, or None in memory."""
        files = self.dataset.files
        if files is None:
            return None
        if self._chunks is None:
            self._chunks = [(f, g) for f in files
                            for g in range(parquet.ParquetFile(f).num_row_groups)]
        return self._chunks

    def _read_chunk(self, chunks, ci: int) -> Dict[str, np.ndarray]:
        cols = self._file_cache.get(ci)
        if cols is None:
            f, g = chunks[ci]
            cols = table_to_numpy(self._own(parquet.ParquetFile(f).read_row_group(
                g, self._names())))
            self._cache_add(ci, cols)
        return cols

    def _all_columns(self) -> Dict[str, np.ndarray]:
        """Every chunk decoded and concatenated (each lands in the cache
        while it has room)."""
        chunks = self._chunk_list()
        if chunks is not None and len(chunks) > 1:
            return parquet.concat_tables([self._read_chunk(chunks, ci)
                                          for ci in range(len(chunks))])
        return self._whole()

    def _num_rows(self, cols: Dict[str, np.ndarray]) -> int:
        for name in self._names():
            if name in cols:
                return len(cols[name])
            if name + OFFSETS in cols:
                return len(cols[name + OFFSETS]) - 1
        return 0

    def _own(self, cols: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The loader's columns of a table."""
        out = {}
        for name in self._names():
            if name in self._list_cols:
                out[name + VALUES] = cols[name + VALUES]
                out[name + OFFSETS] = cols[name + OFFSETS]
            else:
                out[name] = cols[name]
        return out

    # ------------------------------------------------------------------
    # batches
    # ------------------------------------------------------------------
    def _assemble(self, cols: Dict[str, np.ndarray], lo: int, hi: int):
        feats: Dict[str, Any] = {}
        targets: Dict[str, Any] = {}
        pad = self.batch_size - (hi - lo)

        def pad_rows(arr):
            return np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1)) if pad else arr

        for name in self._names():
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
                padded, mask = native.pad_ragged(cols[name + VALUES], offsets, L)
                dest[name] = SequenceFeature(pad_rows(padded), pad_rows(mask))
            else:
                dest[name] = pad_rows(cols[name][lo:hi])
        valid = np.zeros(self.batch_size, dtype=bool)
        valid[: hi - lo] = True
        feats[ROW_VALID_KEY] = valid
        if self.transform is not None:
            feats, targets = self.transform(feats, targets)
        return feats, _collapse(targets)

    def _cols_batches(self, cols: Dict[str, np.ndarray], drop_tail: bool):
        n = self._num_rows(cols)
        full = n // self.batch_size
        for step in range(full):
            lo = step * self.batch_size
            yield self._assemble(cols, lo, lo + self.batch_size)
        if n > full * self.batch_size and not drop_tail:
            yield self._assemble(cols, full * self.batch_size, n)

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

    def _materialize(self) -> Dict[str, np.ndarray]:
        """This pass's rows of the whole table: permuted and taken for this
        process where asked."""
        cols = self._whole()
        n = self._num_rows(cols)
        if not self.shuffle and self.global_size == 1:
            return cols
        if self.shuffle:
            idx = np.random.default_rng(self.epoch_seed()).permutation(n)
        else:
            idx = np.arange(n)
        if self.global_size > 1:
            self._bucket_plan = self._plan_buckets(cols, idx) if self.pad == "bucket" else None
            idx = idx[self.global_rank::self.global_size]
        return take_rows(cols, idx)

    def _batches(self) -> Iterator[Tuple[Dict[str, Any], Any]]:
        chunks = self._chunk_list()
        if chunks is None or len(chunks) <= 1:
            yield from self._cols_batches(self._materialize(), drop_tail=self.drop_last)
            return
        if self.pad == "bucket" and self.global_size > 1 and self._list_cols:
            raise ValueError(
                "pad='bucket' with multi-host sharding needs a global view of row lengths; "
                "the multi-chunk parquet streaming path shards by chunk order and has none. "
                "Use pad='max', or materialize the dataset in memory.")
        rng = np.random.default_rng(self.epoch_seed())
        order = rng.permutation(len(chunks)) if self.shuffle else np.arange(len(chunks))
        if self.global_size > 1:
            order = order[self.global_rank::self.global_size]
        carry: Optional[Dict[str, np.ndarray]] = None
        B = self.batch_size
        for ci in order:
            cols = self._read_chunk(chunks, int(ci))
            if self.shuffle:
                cols = take_rows(cols, rng.permutation(self._num_rows(cols)))
            if carry is not None:
                cols = parquet.concat_tables([carry, cols])
                carry = None
            n = self._num_rows(cols)
            full = n // B * B
            for lo in range(0, full, B):
                yield self._assemble(cols, lo, lo + B)
            if n > full:
                carry = take_rows(cols, np.arange(full, n))
        if carry is not None and not self.drop_last:
            yield from self._cols_batches(carry, drop_tail=False)

    def __iter__(self) -> Iterator[Tuple[Dict[str, Any], Optional[Any]]]:
        self._epoch += 1
        if self.prefetch and self.prefetch > 0:
            return _ThreadedIterator(self._batches(), maxsize=self.prefetch)
        return self._batches()

    def peek(self):
        """The first batch of a pass, assembled here (no thread); the pass
        counter does not move."""
        try:
            return next(iter(self._batches()))
        except StopIteration:
            raise ValueError(
                f"Loader produced no batches: dataset has {self.dataset.num_rows} rows "
                f"for batch_size={self.batch_size} (drop_last={self.drop_last}). "
                "Lower batch_size or generate more rows.") from None

    # ------------------------------------------------------------------
    # the device-resident routes
    # ------------------------------------------------------------------
    def dense_columns(self):
        """The whole dataset's assembled columns for the device-resident
        training route: ``(features, targets, n_rows)``, unshuffled, list
        columns padded to (n, L) values plus mask as
        :class:`SequenceFeature`, no ``__row_valid__`` (the route keeps only
        full batches). The engine uploads them to the device once and
        gathers each chunk's rows there. Raises ``ValueError`` for data it
        cannot hold so: a dataset of no rows, a process's share of one, or
        a per-batch ``transform``."""
        if self.global_size > 1:
            raise ValueError("dense_columns() takes the whole dataset: not with global_size")
        if self.transform is not None:
            raise ValueError("dense_columns() does not support per-batch transforms")
        cols = self._all_columns()
        n = self._num_rows(cols)
        if n == 0:
            raise ValueError("dense_columns() needs a dataset with rows")
        feats: Dict[str, Any] = {}
        targets: Dict[str, Any] = {}
        for name in self._names():
            dest = targets if name in self._target_cols else feats
            if name in self._list_cols:
                dest[name] = SequenceFeature(*native.pad_ragged(
                    cols[name + VALUES], cols[name + OFFSETS], self._list_cols[name]))
            else:
                dest[name] = cols[name]
        return feats, _collapse(targets), n

    def bucketed_dense_columns(self) -> List[Tuple[int, Dict[str, Any], Any, int]]:
        """The whole dataset's columns grouped by length bucket, for the
        device-resident route under ``pad="bucket"``: each row's bucket is the
        power of two at or above its longest list (each list cut at its
        column's max), and each group's list columns are padded to
        min(bucket, the column's max), so that batches taken within a group
        share one shape. ``[(bucket, features, targets, n_rows), ...]`` by
        bucket, each group's rows in dataset order, no ``__row_valid__``."""
        if not self._list_cols or self.global_size > 1:
            raise ValueError("bucketed_dense_columns needs list features and the whole dataset")
        if self.transform is not None:
            raise ValueError("bucketed_dense_columns does not support per-batch transforms")
        cols = self._all_columns()
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
            for name in self._names():
                dest = targets if name in self._target_cols else feats
                if name in self._list_cols:
                    L = min(self._list_cols[name], int(bucket))
                    dest[name] = SequenceFeature(*native.pad_ragged(rows[name + VALUES],
                                                                    rows[name + OFFSETS], L))
                else:
                    dest[name] = rows[name]
            groups.append((int(bucket), feats, _collapse(targets), len(idx)))
        return groups


class _ThreadedIterator:
    """Runs the producer generator on a thread with a bounded queue; an
    exception the producer raises is raised again in the consumer. The
    thread holds the queue and a stop flag, not this object: when the
    consumer drops the iterator before the end, the producer stops at its
    next batch."""

    _END = object()

    def __init__(self, gen, maxsize: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=_produce, args=(gen, self._queue, self._stop),
                                        daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is self._END or isinstance(item, _Raised):
            self._done = True
            if isinstance(item, _Raised):
                raise item.error
            raise StopIteration
        return item

    def __del__(self):
        self._stop.set()


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


def _produce(gen, q: "queue.Queue", stop: threading.Event) -> None:
    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in gen:
            if not put(item):
                return
        put(_ThreadedIterator._END)
    except BaseException as e:  # noqa: BLE001  (handed to the consumer, which raises it)
        put(_Raised(e))
    finally:
        gen.close()


def sample_batch(data: Union[Dataset, Loader, str], batch_size: int = 32, shuffle: bool = False,
                 include_targets: bool = True, to_device: bool = True, device=None):
    """One batch of ``data`` (the first of a pass; the JAX package's
    ``sample_batch``). With ``to_device`` its arrays move to ``device``
    (default the card; without one this raises unless ``device="cpu"``)
    through ``core.types.to_device_batch``; else they stay numpy."""
    loader = data if isinstance(data, Loader) else Loader(data, batch_size, shuffle=shuffle,
                                                          prefetch=0)
    feats, targets = loader.peek()
    if to_device:
        from ..core.device import resolve_device
        from ..core.types import to_device_batch, to_device_targets

        dev = resolve_device(device)
        feats, targets = to_device_batch(feats, dev), to_device_targets(targets, dev)
    if include_targets:
        return feats, targets
    return feats
