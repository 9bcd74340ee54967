"""The program's DLRM (``models_tpu_torch``'s ``DLRMModel``) built to a
configuration, and the benchmark's leaves on its parameters (a table is
its rows of whichever of the program's tables holds its column: a fused
group's, from the column's row offset, or a table of its own)."""

from __future__ import annotations

from typing import Dict

import torch

from ...program_leaves import Leaf
from ..schema import dataset, program_schema  # noqa: F401 (the entries' names)
from .reference import leaf_specs


def build(cfg: dict, device):
    import models_tpu_torch as mt

    bot, top = cfg["arch_mlp_bot"], cfg["arch_mlp_top"]
    return mt.DLRMModel(program_schema(cfg), embedding_dim=cfg["arch_sparse_feature_size"],
                        bottom_block=tuple(bot[1:-1]), top_block=tuple(top[:-1]),
                        device=device)


def table_rows(model) -> Dict[str, tuple]:
    """Column name -> (the table parameter that holds it, its first row)."""
    out = {}
    for module in model.modules():
        table = getattr(module, "table", None)
        if not isinstance(table, torch.nn.Parameter):
            continue
        starts = getattr(module, "row_offsets", [0] * len(module.features))
        for name, start in zip(module.features, starts):
            out[name] = (table, int(start))
    return out


def leaves(model, cfg: dict) -> Dict[str, Leaf]:
    params = dict(model.named_parameters())
    tables = table_rows(model)
    out = {}
    for name, shape, _ in leaf_specs(cfg):
        part, rest = name.split(".", 1)
        if part == "table":
            table, start = tables[rest]
            out[name] = Leaf(table, rows=shape[0], start=start)
        elif part == "head":
            out[name] = Leaf(params[f"blocks.1.to_call.{rest}"])
        else:
            layer, field = rest.split(".")
            out[name] = Leaf(params[f"blocks.0.{part}.layers.{int(layer[len('dense'):])}.{field}"])
        if tuple(out[name].value().shape) != tuple(shape):
            raise ValueError(f"{name}: the program's {tuple(out[name].value().shape)} is not "
                             f"the configuration's {tuple(shape)}")
    return out
