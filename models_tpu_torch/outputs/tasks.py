"""The V1 prediction tasks (``models_tpu/outputs/tasks.py``):
:class:`ParallelPredictionBlock`, :func:`PredictionTasks` and
:func:`NextItemPredictionTask`.

Widths are given at construction: ``in_features`` is the body's width,
a tower's or a pre block's ``out_features`` the head's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

from torch import nn

from ..blocks.mlp import Dense
from ..core.block import Block, fresh_copy
from ..core.combinators import SequentialBlock
from ..core.device import resolve_device
from ..schema import Schema, Tags
from .base import BinaryOutput, CategoricalOutput, ModelOutput, RegressionOutput
from .contrastive import ContrastiveOutput
from .sampling import PopularityBasedSampler


def NextItemPredictionTask(
    schema: Schema,
    weight_tying: bool = True,
    table=None,
    sampled_softmax: bool = False,
    num_sampled: int = 100,
    logits_temperature: float = 1.0,
    target_name: Optional[str] = None,
    in_features: Optional[int] = None,
    device=None,
) -> ModelOutput:
    """A next-item head over the item catalog. ``weight_tying`` with the
    item ``table``: logits ``hidden @ table.T`` (a tied
    :class:`CategoricalOutput`); without a table a dense head over the
    item column's cardinality (``in_features`` wide). ``sampled_softmax``:
    a :class:`ContrastiveOutput` on the tied table with ``num_sampled``
    popularity-sampled negatives a step and the logQ correction (its fused
    loss is K1-K3 on the card). Pair it with a sequence transform as
    ``fit(pre=...)``."""
    item_col = schema.select_by_tag(Tags.ITEM_ID).first
    target = target_name or item_col.name
    if sampled_softmax:
        if table is None:
            raise ValueError("sampled_softmax needs the tied item EmbeddingTable")
        return ContrastiveOutput(
            table, target=target, logits_temperature=logits_temperature,
            negative_samplers=[PopularityBasedSampler(max_num_samples=num_sampled,
                                                      max_id=item_col.cardinality - 1,
                                                      device=table.table.device)])
    if weight_tying and table is not None:
        return CategoricalOutput(table, target=target, logits_temperature=logits_temperature)
    return CategoricalOutput(item_col, in_features=in_features, target=target,
                             logits_temperature=logits_temperature,
                             device=resolve_device(device))


class ParallelPredictionBlock(Block):
    """The V1 multi-task container: the heads by name, run in sorted key
    order (as the JAX package's jitted step orders them), with two V1
    facilities:

    - ``bias_block``: a shared block over the body's output whose
      ``bias_logit`` (a Dense(1) over its ``out_features``) is added to
      every head's logits ((B, 1) logits take it as it is, (B,) logits its
      column);
    - ``task_weight_dict``: loss weights by head name that ``compile``
      takes where its ``loss_weights`` names no weight for the head.
    """

    def __init__(self, heads: Dict[str, ModelOutput], bias_block: Optional[nn.Module] = None,
                 task_weight_dict: Optional[Dict[str, float]] = None, device=None):
        super().__init__(block_name="parallel_prediction_block")
        self.heads = nn.ModuleDict(dict(heads))
        self.bias_block = bias_block
        self.bias_logit = (None if bias_block is None else
                           Dense(1, in_features=getattr(bias_block, "out_features", None),
                                 device=resolve_device(device)))
        self.task_weight_dict = {str(k): float(v) for k, v in (task_weight_dict or {}).items()}

    def forward(self, inputs, *, training=False, context=None, targets=None, **kwargs):
        bias = None
        if self.bias_block is not None:
            bias = self.bias_logit(self.bias_block(inputs, training=training, context=context))
        out = {}
        for name in sorted(self.heads):
            pred = self.heads[name](inputs, training=training, context=context, targets=targets)
            if bias is not None and pred.outputs is not None:
                add = bias if pred.outputs.ndim >= 2 else bias[:, 0]
                pred = pred._replace(outputs=pred.outputs + add)
            out[name] = pred
        return out


def PredictionTasks(
    schema: Schema,
    task_blocks: Union[None, nn.Module, Dict[str, nn.Module], Callable[[], nn.Module]] = None,
    task_weight_dict: Optional[Dict[str, float]] = None,
    task_pre_dict: Optional[Dict[str, nn.Module]] = None,
    bias_block: Optional[nn.Module] = None,
    logits_temperature: float = 1.0,
    in_features: Optional[int] = None,
    device=None,
) -> ParallelPredictionBlock:
    """A V1 multi-task block from the schema's TARGET columns, each a head as
    ``OutputBlock`` picks it, over the body's ``in_features``.

    - ``task_blocks``: a tower by target; or ONE block, cloned for each task
      by ``fresh_copy(salt=index + 1)`` (weights drawn anew); or a factory
      called once a task;
    - ``task_pre_dict``: a block by target, applied after the tower;
    - ``task_weight_dict``: loss weights by target (or head) name, mapped
      onto the head names;
    - ``bias_block``: a shared bias tower whose logit every head adds.
    """
    targets = schema.targets
    if not len(targets):
        raise ValueError("Schema has no TARGET-tagged columns")
    dev = resolve_device(device)

    def tower_for(name: str, index: int) -> Optional[nn.Module]:
        if task_blocks is None:
            return None
        if isinstance(task_blocks, dict):
            return task_blocks.get(name)
        if isinstance(task_blocks, nn.Module):
            return fresh_copy(task_blocks, salt=index + 1)
        if callable(task_blocks):
            return task_blocks()
        raise ValueError("task_blocks must be a block, a dict or a factory")

    heads: Dict[str, ModelOutput] = {}
    for i, col in enumerate(targets):
        parts = [b for b in (tower_for(col.name, i), (task_pre_dict or {}).get(col.name))
                 if b is not None]
        kw = dict(logits_temperature=logits_temperature, device=dev,
                  in_features=getattr(parts[-1], "out_features", None) if parts else in_features)
        if parts:
            kw["pre"] = parts[0] if len(parts) == 1 else SequentialBlock(parts)
        if col.has_tag(Tags.REGRESSION) or (
                col.dtype.startswith("float") and not col.has_tag(Tags.BINARY_CLASSIFICATION)):
            head = RegressionOutput(col.name, **kw)
        elif col.has_tag(Tags.MULTI_CLASS_CLASSIFICATION) and col.int_domain:
            head = CategoricalOutput(col, **kw)
        else:
            head = BinaryOutput(col.name, **kw)
        heads[head.block_name] = head
    weights = {}
    for k, v in (task_weight_dict or {}).items():
        for h in [h for h in heads if h == k or h.split("/")[0] == k] or [k]:
            weights[h] = float(v)
    return ParallelPredictionBlock(heads, bias_block=bias_block, task_weight_dict=weights,
                                   device=dev)
