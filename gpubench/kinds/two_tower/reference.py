"""The plain two-tower: plain PyTorch in float32, no kernel of the program.

Each tower concatenates its columns in sorted name order (a categorical
column's table row, a list column's rows averaged over its mask, a
continuous column as one value), then an MLP whose hidden layers take a ReLU
and whose last layer is linear. The loss is the in-batch sampled softmax:
row i's logits are its positive ``q_i . c_i`` and ``q_i . c_j`` for every
row j whose item id differs from row i's, ``loss_i = logsumexp(logits_i) -
q_i . c_i``, averaged over the rows. The top k scores a query against
every catalog row and keeps the ``k`` best, ties to the lower row.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import weights
from ...reference import follow_adagrad
from ...traffic import VALUES, padded_list


def tower_columns(cfg: dict, side: str) -> List[dict]:
    tag = "user" if side == "query" else "item"
    return sorted((c for c in cfg["columns"] if tag in c["tags"]), key=lambda c: c["name"])


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every leaf, in a fixed order."""
    D, init = cfg["embedding_dim"], cfg["init"]
    specs = []
    for side, widths in (("query", cfg["query_tower"]), ("item", cfg["item_tower"])):
        width = 0
        for col in tower_columns(cfg, side):
            if col["type"].startswith("categorical"):
                specs.append((f"{side}.table.{col['name']}", (col["max_id"] + 1, D),
                              tuple(init["tables"])))
                width += D
            else:
                width += 1
        for j, units in enumerate(widths):
            specs.append((f"{side}.dense{j}.weight", (units, width), tuple(init["dense_weights"])))
            specs.append((f"{side}.dense{j}.bias", (units,), tuple(init["dense_biases"])))
            width = units
    return specs


def tower(cfg: dict, side: str, params: Dict[str, torch.Tensor], batch: dict) -> torch.Tensor:
    """(B, D): one tower over ``batch`` (column name -> tensor; a list
    column as (values, mask))."""
    parts = []
    for col in tower_columns(cfg, side):
        name = col["name"]
        if col["type"] == "categorical":
            parts.append(F.embedding(batch[name], params[f"{side}.table.{name}"]))
        elif col["type"] == "categorical_list":
            values, mask = batch[name]
            rows = F.embedding(values, params[f"{side}.table.{name}"])
            m = mask.to(rows.dtype)[..., None]
            parts.append((rows * m).sum(1) / m.sum(1).clamp_min(1.0))
        else:
            parts.append(batch[name].to(torch.float32)[:, None])
    x = torch.cat(parts, dim=1)
    widths = cfg["query_tower" if side == "query" else "item_tower"]
    for j in range(len(widths)):
        x = F.linear(x, params[f"{side}.dense{j}.weight"], params[f"{side}.dense{j}.bias"])
        if j < len(widths) - 1:
            x = torch.relu(x)
    return x


def item_id(cfg: dict) -> str:
    return next(c["name"] for c in cfg["columns"] if "item_id" in c["tags"])


def loss(cfg: dict, params: Dict[str, torch.Tensor], batch: dict) -> torch.Tensor:
    q = tower(cfg, "query", params, batch)
    c = tower(cfg, "item", params, batch)
    ids = batch[item_id(cfg)]
    pos = (q * c).sum(1)
    logits = (q @ c.T).masked_fill(ids[None, :] == ids[:, None], float("-inf"))
    lse = torch.logsumexp(torch.cat([pos[:, None], logits], dim=1), dim=1)
    return (lse - pos).mean()


@torch.no_grad()
def top_k(queries: torch.Tensor, catalog: torch.Tensor, k: int,
          block: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores, rows) of the ``k`` best catalog rows of each query, in
    blocks of queries."""
    scores, rows = [], []
    for lo in range(0, queries.shape[0], block):
        s = queries[lo:lo + block] @ catalog.T
        top = torch.topk(s, k, dim=1, sorted=True)
        scores.append(top.values)
        rows.append(top.indices)
    return torch.cat(scores), torch.cat(rows)


def batch(cfg: dict, data: dict, rows: np.ndarray, device) -> dict:
    """Rows ``rows`` of the drawn columns as the reference's tensors."""
    out = {}
    for col in cfg["columns"]:
        name = col["name"]
        if col["type"] == "categorical_list":
            if name + VALUES in data:
                values, mask = padded_list(data, name, rows, col["max_len"])
                out[name] = (torch.from_numpy(values).to(device),
                             torch.from_numpy(mask).to(device))
        elif name not in data:
            continue
        elif col["type"] == "categorical":
            out[name] = torch.from_numpy(data[name][rows].astype(np.int64)).to(device)
        else:
            out[name] = torch.from_numpy(data[name][rows]).to(device)
    return out


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return {n: weights.make(shape, init, seed, i, device)
            for i, (n, shape, init) in enumerate(leaf_specs(cfg))}


def follow(cfg: dict, data: dict, order: np.ndarray, batch_size: int, steps: int,
           change_at: int, seed: int, device) -> dict:
    """``steps`` training steps from the seed's weights, step i on rows
    ``order[i * batch_size:(i + 1) * batch_size]``: every step's loss, the
    first gradients' norms and the changes' norms after ``change_at``."""
    params = make_params(cfg, seed, device)
    return follow_adagrad(
        lambda p, b: loss(cfg, p, b), params,
        lambda i: batch(cfg, data, order[i * batch_size:(i + 1) * batch_size], device),
        steps, change_at, cfg["learning_rate"], cfg["adagrad_initial_accumulator"],
        cfg["adagrad_eps"])
