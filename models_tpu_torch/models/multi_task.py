"""The multi-task models (``models_tpu/models/multi_task.py``): MMOE and PLE
over the input block, with a head a TARGET column
(:func:`~models_tpu_torch.outputs.base.OutputBlock`); each head reads its
task's entry of the body's dict (the ``"shared"`` entry of a CGC layer
that is not final is read by none). Weights are drawn from ``seed`` on
``device`` (default the card).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

from torch import nn

from ..blocks.experts import MMOEBlock, PLEBlock
from ..core.combinators import SequentialBlock
from ..core.device import resolve_device
from ..inputs.base import InputBlockV2
from ..outputs.base import OutputBlock
from ..schema import Schema
from .base import Model


def _tasks(schema: Schema, name: str) -> list:
    tasks = schema.targets.column_names
    if len(tasks) < 2:
        raise ValueError(f"{name} expects >= 2 TARGET columns")
    return tasks


def _model(schema, inputs, body_block, task_blocks, name, dev) -> Model:
    body = SequentialBlock([inputs, body_block])
    model = Model(body, OutputBlock(schema, in_features=body_block.out_features,
                                    task_blocks=task_blocks, device=dev))
    model.schema = schema
    model.block_name = name
    return model


def MMOEModel(
    schema: Schema,
    expert_block: Union[nn.Module, Sequence[int]] = (64, 32),
    num_experts: int = 4,
    task_blocks: Optional[Dict[str, nn.Module]] = None,
    embedding_dim: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> Model:
    """``expert_block``: the experts' widths, or a block over the input
    block's width (``out_features`` set). ``task_blocks``: a tower by
    target, over the experts' width."""
    tasks = _tasks(schema, "MMOEModel")
    dev = resolve_device(device)
    inputs = InputBlockV2(schema, dim=embedding_dim, seed=seed, device=dev)
    mmoe = MMOEBlock(tasks, expert_block, inputs.out_features, num_experts=num_experts,
                     seed=seed, device=dev)
    return _model(schema, inputs, mmoe, task_blocks, "mmoe", dev)


def PLEModel(
    schema: Schema,
    expert_block: Union[nn.Module, Sequence[int]] = (64, 32),
    num_layers: int = 2,
    num_task_experts: int = 1,
    num_shared_experts: int = 2,
    task_blocks: Optional[Dict[str, nn.Module]] = None,
    embedding_dim: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> Model:
    tasks = _tasks(schema, "PLEModel")
    dev = resolve_device(device)
    inputs = InputBlockV2(schema, dim=embedding_dim, seed=seed, device=dev)
    ple = PLEBlock(tasks, expert_block, inputs.out_features, num_layers=num_layers,
                   num_task_experts=num_task_experts, num_shared_experts=num_shared_experts,
                   seed=seed, device=dev)
    return _model(schema, inputs, ple, task_blocks, "ple", dev)
