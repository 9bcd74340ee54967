"""The plain DLRM: plain PyTorch in float32, no kernel of the program.

facebookresearch/dlrm's layers at the configuration's widths: the dense
columns, in sorted name order, through the bottom MLP (ReLU after every
layer); each categorical column's table row; the bottom output and the rows
stacked, categorical columns in sorted name order and the bottom output
last; the dot products of every pair (the gram's upper triangle, row by
row) after the bottom output; the top MLP (ReLU after every layer but the
last, a linear layer of one unit); binary cross-entropy on that logit,
averaged over the rows.

A table's leaf may hold only some of its rows (``compact``): ids are then
looked up through the sorted rows it holds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import weights
from ...reference import follow_adagrad


def dense_columns(cfg: dict) -> List[str]:
    return sorted(c["name"] for c in cfg["columns"] if c["type"] == "continuous")


def sparse_columns(cfg: dict) -> List[dict]:
    return sorted((c for c in cfg["columns"] if c["type"] == "categorical"),
                  key=lambda c: c["name"])


def label_column(cfg: dict) -> str:
    return next(c["name"] for c in cfg["columns"] if c["type"] == "binary")


def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every leaf, in a fixed order: the tables in
    the configuration's column order, the bottom, top and head layers."""
    D, init = cfg["arch_sparse_feature_size"], cfg["init"]
    specs = [(f"table.{c['name']}", (c["max_id"] + 1, D), tuple(init["tables"]))
             for c in cfg["columns"] if c["type"] == "categorical"]
    bot = cfg["arch_mlp_bot"]
    for j in range(len(bot) - 1):
        specs.append((f"bottom.dense{j}.weight", (bot[j + 1], bot[j]),
                      tuple(init["dense_weights"])))
        specs.append((f"bottom.dense{j}.bias", (bot[j + 1],), tuple(init["dense_biases"])))
    n_feat = len(sparse_columns(cfg)) + 1
    width = D + n_feat * (n_feat - 1) // 2
    top = cfg["arch_mlp_top"]
    for j, units in enumerate(top):
        name = "head" if j == len(top) - 1 else f"top.dense{j}"
        specs.append((f"{name}.weight", (units, width), tuple(init["dense_weights"])))
        specs.append((f"{name}.bias", (units,), tuple(init["dense_biases"])))
        width = units
    return specs


def logits(cfg: dict, params: Dict[str, torch.Tensor], batch: dict,
           held: Dict[str, torch.Tensor] = None) -> torch.Tensor:
    """(B,) logits. ``held[name]``: the sorted ids a compact table holds."""
    x = torch.stack([batch[n].to(torch.float32) for n in dense_columns(cfg)], dim=1)
    bot = cfg["arch_mlp_bot"]
    for j in range(len(bot) - 1):
        x = torch.relu(F.linear(x, params[f"bottom.dense{j}.weight"],
                                params[f"bottom.dense{j}.bias"]))
    feats = []
    for col in sparse_columns(cfg):
        ids = batch[col["name"]]
        if held is not None:
            ids = torch.searchsorted(held[col["name"]], ids)
        feats.append(F.embedding(ids, params[f"table.{col['name']}"]))
    feats.append(x)
    stacked = torch.stack(feats, dim=1)  # (B, F, D)
    gram = torch.bmm(stacked, stacked.transpose(1, 2))
    i, j = torch.triu_indices(stacked.shape[1], stacked.shape[1], offset=1,
                              device=stacked.device)
    h = torch.cat([x, gram[:, i, j]], dim=1)
    top = cfg["arch_mlp_top"]
    for j in range(len(top) - 1):
        h = torch.relu(F.linear(h, params[f"top.dense{j}.weight"], params[f"top.dense{j}.bias"]))
    return F.linear(h, params["head.weight"], params["head.bias"])[:, 0]


def loss(cfg: dict, params: Dict[str, torch.Tensor], batch: dict,
         held: Dict[str, torch.Tensor] = None) -> torch.Tensor:
    y = batch[label_column(cfg)].to(torch.float32)
    return F.binary_cross_entropy_with_logits(logits(cfg, params, batch, held), y)


def batch(cfg: dict, data: dict, rows: np.ndarray, device) -> dict:
    """Rows ``rows`` of the drawn columns as the reference's tensors."""
    out = {}
    for col in cfg["columns"]:
        values = data[col["name"]][rows]
        if col["type"] == "categorical":
            values = values.astype(np.int64)
        out[col["name"]] = torch.from_numpy(values).to(device)
    return out


def follow(cfg: dict, data: dict, order: np.ndarray, batch_size: int, steps: int,
           change_at: int, seed: int, device) -> dict:
    """``steps`` training steps from the seed's weights, step i on rows
    ``order[i * batch_size:(i + 1) * batch_size]``, each table held as the
    rows the steps look up: every step's loss, the first gradients' norms
    and the changes' norms after ``change_at``."""
    rows = order[:steps * batch_size]
    held = {c["name"]: torch.from_numpy(np.unique(data[c["name"]][rows]).astype(np.int64))
            .to(device) for c in sparse_columns(cfg)}
    params = {}
    for i, (name, shape, init) in enumerate(leaf_specs(cfg)):
        full = weights.make(shape, init, seed, i, device)
        if name.startswith("table."):
            full = full[held[name[len("table."):]]]
        params[name] = full
    return follow_adagrad(
        lambda p, b: loss(cfg, p, b, held), params,
        lambda i: batch(cfg, data, order[i * batch_size:(i + 1) * batch_size], device),
        steps, change_at, cfg["learning_rate"], cfg["adagrad_initial_accumulator"],
        cfg["adagrad_eps"])
