"""The two-tower's work by count (``gpubench/work.py``'s conventions)."""

from __future__ import annotations

import numpy as np

from ...traffic import padded_list
from ...work import adagrad_bytes, dense_flops, train_from_forward, unique_count
from .reference import leaf_specs


def _dense(cfg: dict, side: str):
    return [s for n, s, _ in leaf_specs(cfg) if n.startswith(side) and n.endswith(".weight")]


def tower_flops(cfg: dict, side: str, batch: int) -> float:
    return dense_flops(batch, _dense(cfg, side))


def loss_flops(cfg: dict, batch: int) -> float:
    """The in-batch logits, the queries' and the candidates' gradients:
    three products of 2 B B D."""
    return 3 * 2.0 * batch * batch * cfg["embedding_dim"]


def loss_bytes(cfg: dict, batch: int) -> float:
    """Queries and candidates read and their gradients written, each (B, D);
    the ids, the bias and the log-sum-exp, one float32 a row each."""
    return 4.0 * (4 * batch * cfg["embedding_dim"] + 4 * batch)


def train_flops(cfg: dict, batch: int) -> float:
    towers = tower_flops(cfg, "query", batch) + tower_flops(cfg, "item", batch)
    return train_from_forward(towers) + loss_flops(cfg, batch)


def dense_params(cfg: dict) -> int:
    return sum(int(np.prod(s)) for n, s, _ in leaf_specs(cfg) if ".table." not in n)


def optimizer_bytes(cfg: dict, data: dict, rows: np.ndarray) -> float:
    """One step's Adagrad bytes over the batch ``rows``."""
    touched = 0
    for col in cfg["columns"]:
        name = col["name"]
        if col["type"] == "categorical":
            touched += unique_count(data[name][rows])
        elif col["type"] == "categorical_list":
            values, mask = padded_list(data, name, rows, col["max_len"])
            touched += unique_count(values[mask])
    return adagrad_bytes(touched, cfg["embedding_dim"], dense_params(cfg))


def query_flops(cfg: dict, batch: int) -> float:
    return tower_flops(cfg, "query", batch)
