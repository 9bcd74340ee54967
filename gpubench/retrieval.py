"""What the retrieval entries share: the catalog and the queries drawn from
the seed, the weights made once for the program and the reference, and the
reference's towers over them.

The catalog is one row per item id, ``0 .. max_id`` (a row's position is
its id), its other item columns drawn from the seed; queries are rows of
the query tower's columns."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import traffic as traffic_mod, weights


def item_id_column(cfg: dict) -> dict:
    return next(c for c in cfg["columns"] if "item_id" in c["tags"])


def draw_catalog(cfg: dict, rng: np.random.Generator, skew: float) -> Dict[str, np.ndarray]:
    item = item_id_column(cfg)
    n = item["max_id"] + 1
    cols = [c for c in cfg["columns"] if "item" in c["tags"] and c is not item]
    data = traffic_mod.draw_columns(cols, n, rng, skew)
    data[item["name"]] = np.arange(n, dtype=np.int32)
    return data


def draw_queries(cfg: dict, n: int, rng: np.random.Generator, skew: float) -> Dict[str, np.ndarray]:
    cols = [c for c in cfg["columns"] if "user" in c["tags"]]
    return traffic_mod.draw_columns(cols, n, rng, skew)


def fill_program(leaves, specs, seed: int) -> None:
    with torch.no_grad():
        for i, (name, _, init) in enumerate(specs):
            weights.fill_(leaves[name].value(), init, seed, i)


@torch.no_grad()
def embed(reference, cfg: dict, params, side: str, data: dict, n: int, device,
          block: int = 65536) -> torch.Tensor:
    """(n, D): the reference's ``side`` tower over the ``n`` rows of ``data``."""
    out = []
    for lo in range(0, n, block):
        rows = np.arange(lo, min(n, lo + block))
        out.append(reference.tower(cfg, side, params, reference.batch(cfg, data, rows, device)))
    return torch.cat(out)


def rank_metrics(ranks: np.ndarray, k: int) -> Dict[str, float]:
    """The top-k metrics of one relevant item a query at 1-based ``ranks``
    (0 where it is not in the top k): recall, precision, mrr, map and ndcg
    at k."""
    hit = (ranks >= 1) & (ranks <= k)
    inv = np.where(hit, 1.0 / np.maximum(ranks, 1), 0.0)
    return {
        f"recall_at_{k}": float(hit.mean()),
        f"precision_at_{k}": float(hit.mean() / k),
        f"mrr_at_{k}": float(inv.mean()),
        f"map_at_{k}": float(inv.mean()),
        f"ndcg_at_{k}": float(np.where(hit, 1.0 / np.log2(np.maximum(ranks, 1) + 1.0), 0.0).mean()),
    }


def labels_at(query_emb: torch.Tensor, catalog_emb: torch.Tensor, ranks: np.ndarray,
              reference_top_k) -> np.ndarray:
    """The catalog row (the item id) at each query's 1-based rank ``ranks``
    of the reference's scores."""
    _, rows = reference_top_k(query_emb, catalog_emb, int(ranks.max()))
    return rows.cpu().numpy()[np.arange(len(ranks)), ranks - 1]
