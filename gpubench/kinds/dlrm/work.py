"""The DLRM's work by count (``gpubench/work.py``'s conventions)."""

from __future__ import annotations

import numpy as np

from ...work import adagrad_bytes, dense_flops, train_from_forward, unique_count
from .reference import leaf_specs, sparse_columns


def forward_flops(cfg: dict, batch: int) -> float:
    """The bottom, top and head layers, and the interaction's gram of the
    F = tables + 1 stacked rows (2 B F F D, as the batched product forms it)."""
    mlps = [s for n, s, _ in leaf_specs(cfg) if not n.startswith("table.")
            and n.endswith(".weight")]
    f = len(sparse_columns(cfg)) + 1
    return dense_flops(batch, mlps) + 2.0 * batch * f * f * cfg["arch_sparse_feature_size"]


def train_flops(cfg: dict, batch: int) -> float:
    return train_from_forward(forward_flops(cfg, batch))


def dense_params(cfg: dict) -> int:
    return sum(int(np.prod(s)) for n, s, _ in leaf_specs(cfg) if not n.startswith("table."))


def optimizer_bytes(cfg: dict, data: dict, rows: np.ndarray) -> float:
    """One step's Adagrad bytes over the batch ``rows``."""
    touched = sum(unique_count(data[c["name"]][rows]) for c in sparse_columns(cfg))
    return adagrad_bytes(touched, cfg["arch_sparse_feature_size"], dense_params(cfg))
