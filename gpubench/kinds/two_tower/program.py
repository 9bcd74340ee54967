"""The program's two-tower (``models_tpu_torch``'s ``TwoTowerModel``) built
to a configuration, and the benchmark's leaves on its parameters."""

from __future__ import annotations

from typing import Dict

from ...program_leaves import Leaf
from ..schema import dataset, program_schema  # noqa: F401 (the entries' names)
from .reference import leaf_specs

TOWER = {"query": "_query", "item": "_candidate"}


def build(cfg: dict, device):
    import models_tpu_torch as mt

    return mt.TwoTowerModel(program_schema(cfg), query_tower=tuple(cfg["query_tower"]),
                            item_tower=tuple(cfg["item_tower"]),
                            embedding_dim=cfg["embedding_dim"], device=device)


def leaves(model, cfg: dict) -> Dict[str, Leaf]:
    params = dict(model.named_parameters())
    out = {}
    for name, shape, _ in leaf_specs(cfg):
        side, part, rest = name.split(".", 2)
        tower = TOWER[side]
        if part == "table":
            p = params[f"{tower}.layers.0.branches.categorical.branches.{rest}.table"]
            out[name] = Leaf(p, rows=shape[0])
        else:
            j = int(part[len("dense"):])
            out[name] = Leaf(params[f"{tower}.layers.{j + 1}.{rest}"])
        if tuple(out[name].value().shape) != tuple(shape):
            raise ValueError(f"{name}: the program's {tuple(out[name].value().shape)} is not "
                             f"the configuration's {tuple(shape)}")
    return out

