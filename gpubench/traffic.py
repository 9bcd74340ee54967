"""The one generator of the benchmark's traffic: rows of a configuration's
columns drawn from a seed, and the row order a shuffled ``fit`` trains in.

The draws copy the program's synthetic sampler
(``models_tpu_torch/data/synthetic.py::_sample_values``) so that a later
change to the program cannot move the yardstick: a categorical column of
largest id ``N`` takes ids in ``[1, N]`` (id 0 is reserved) with probability
proportional to ``(id + 1) ** -skew`` (0.75 there); a list column takes
lengths uniform in ``[max_len // 2, max_len]``; a continuous column is
standard normal; a binary column is 0 or 1 uniformly. Lists are returned
encoded (``<name>__values``, ``<name>__offsets``), as the program's
``Dataset`` stores them.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

VALUES, OFFSETS = "__values", "__offsets"
# the program's Loader: a shuffled pass p (from 1) draws its permutation
# from seed + p * 9973, and every fit of a Dataset starts a new Loader
LOADER_SEED, EPOCH_STRIDE = 0, 9973


class IdSampler:
    """Skewed ids of one categorical domain, by the inverse of its CDF
    (what ``Generator.choice(p=)`` does, without rebuilding the CDF a call)."""

    def __init__(self, max_id: int, skew: float):
        card = max_id + 1
        self.lo = 1 if card > 2 else 0
        weights = 1.0 / np.arange(self.lo + 1, card + 1, dtype=np.float64) ** skew
        self.cdf = np.cumsum(weights)
        self.cdf /= self.cdf[-1]

    def __call__(self, n: int, rng: np.random.Generator) -> np.ndarray:
        idx = np.searchsorted(self.cdf, rng.random(n), side="right")
        return (np.minimum(idx, len(self.cdf) - 1) + self.lo).astype(np.int32)


def draw_columns(columns: Iterable[dict], n_rows: int, rng: np.random.Generator,
                 skew: float) -> Dict[str, np.ndarray]:
    """``n_rows`` rows of each column, in the columns' order, from ``rng``."""
    out: Dict[str, np.ndarray] = {}
    for col in columns:
        name, kind = col["name"], col["type"]
        if kind == "categorical":
            out[name] = IdSampler(col["max_id"], skew)(n_rows, rng)
        elif kind == "categorical_list":
            top = col["max_len"]
            lengths = rng.integers(max(1, top // 2), top + 1, size=n_rows)
            offsets = np.zeros(n_rows + 1, dtype=np.int64)
            np.cumsum(lengths, out=offsets[1:])
            out[name + VALUES] = IdSampler(col["max_id"], skew)(int(offsets[-1]), rng)
            out[name + OFFSETS] = offsets
        elif kind == "continuous":
            out[name] = rng.normal(size=n_rows).astype(np.float32)
        elif kind == "binary":
            out[name] = rng.integers(0, 2, size=n_rows).astype(np.int32)
        else:
            raise ValueError(f"column {name}: unknown type {kind!r}")
    return out


def column_names(data: Dict[str, np.ndarray]) -> list:
    """The column names of encoded ``data`` (a list column once)."""
    names = []
    for key in data:
        base = key[: -len(VALUES)] if key.endswith(VALUES) else (
            key[: -len(OFFSETS)] if key.endswith(OFFSETS) else key)
        if base not in names:
            names.append(base)
    return names


def padded_list(data: Dict[str, np.ndarray], name: str, rows: np.ndarray, max_len: int):
    """Rows ``rows`` of the list column ``name`` as (values (n, max_len)
    int64 padded with 0, mask (n, max_len) bool)."""
    offsets, values = data[name + OFFSETS], data[name + VALUES]
    starts, lengths = offsets[rows], offsets[rows + 1] - offsets[rows]
    pos = np.arange(max_len)[None, :]
    mask = pos < lengths[:, None]
    idx = np.where(mask, starts[:, None] + pos, 0)
    return np.where(mask, values[idx], 0).astype(np.int64), mask


def fit_order(n_rows: int, shuffle: bool = True) -> np.ndarray:
    """The row order of one ``fit(epochs=1)`` over a Dataset of ``n_rows``:
    batch i is rows ``order[i * B:(i + 1) * B]``."""
    if not shuffle:
        return np.arange(n_rows)
    return np.random.default_rng(LOADER_SEED + 1 * EPOCH_STRIDE).permutation(n_rows)
