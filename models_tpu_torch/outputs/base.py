"""Model output heads (``models_tpu/outputs/base.py``).

A head maps the body's output to logits and emits a :class:`Prediction`
with its bound target and sample weight; it carries its default loss and
metrics, which ``Model.compile`` resolves per head, and the ``activation``
that ``Model.predict`` applies to its logits. Ported: the temperature
scaler, ``ModelOutput``, ``RegressionOutput``, ``BinaryOutput``,
``CategoricalTarget``, ``CategoricalOutput``, ``ColumnBasedSampleWeight`` and
``OutputBlock`` (heads from the schema's TARGET columns), the
weight-tying head ``EmbeddingTablePrediction`` (also as
``CategoricalOutput``'s ``to_call``) and ``DotProduct``. A head's width is
given at construction (``in_features``: the body's ``out_features``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..blocks.mlp import Dense
from ..core.block import Block
from ..core.combinators import ParallelBlock
from ..core.policy import cast_compute
from ..core.types import Prediction, SequenceFeature
from ..schema import ColumnSchema, Schema, Tags


class LogitsTemperatureScaler(Block):
    """logits / T."""

    def __init__(self, temperature: float):
        super().__init__()
        self.temperature = float(temperature)

    def forward(self, inputs, **kwargs):
        return inputs / self.temperature


class ModelOutput(Block):
    """Head base: ``pre -> to_call -> temperature`` gives the logits, then
    the target binding, the sample weights of the feature
    ``sample_weight_column`` where one is named, and the ``post`` block
    (more sample weights: :class:`ColumnBasedSampleWeight`) on the
    :class:`Prediction`. The head's ``block_name``, ``task_name`` or else
    ``"<target>/<class>"``, names its loss in the logs.
    """

    default_loss: str = "mse"

    def __init__(self, target: Optional[str] = None, post=None, logits_temperature: float = 1.0,
                 to_call: Optional[nn.Module] = None, pre: Optional[nn.Module] = None,
                 sample_weight_column: Optional[str] = None, task_name: Optional[str] = None):
        super().__init__(block_name=task_name or (
            f"{target}/{type(self).__name__}" if target else type(self).__name__))
        self.target = target
        self.sample_weight_column = sample_weight_column
        self.to_call = to_call
        self.pre = pre
        self.post = post
        self.logits_scaler = (
            LogitsTemperatureScaler(logits_temperature) if logits_temperature != 1.0 else None
        )

    def default_metrics(self) -> list:
        return []

    def bind_target(self, targets):
        if targets is None:
            return None
        if isinstance(targets, dict):
            if self.target is not None:
                return targets.get(self.target)
            if len(targets) == 1:
                return next(iter(targets.values()))
            return None
        return targets

    def activation(self, logits):
        """The user-facing prediction of the logits (``predict``)."""
        return logits

    def logits(self, inputs, **kwargs):
        out = inputs
        # a multi-task body emits a dict by task: take this head's
        if isinstance(out, dict) and self.target is not None and self.target in out:
            out = out[self.target]
        if self.pre is not None:
            out = self.pre(out, **kwargs)
        if self.to_call is not None:
            out = self.to_call(out, **kwargs)
        if self.logits_scaler is not None:
            out = self.logits_scaler(out)
        return out

    def forward(self, inputs, *, training=False, context=None, targets=None, **kwargs):
        logits = self.logits(inputs, training=training, context=context, targets=targets)
        sw = None
        if self.sample_weight_column is not None and context is not None:
            sw = context.features.get(self.sample_weight_column)
            sw = None if sw is None else sw.to(torch.float32)
        pred = Prediction(outputs=logits, targets=self.bind_target(targets), sample_weight=sw)
        if self.post is not None:
            pred = self.post(pred, training=training, context=context, targets=targets)
        return pred


def _squeeze_last(x: torch.Tensor) -> torch.Tensor:
    return x[..., 0] if x.ndim > 1 and x.shape[-1] == 1 else x


def _target_name(target) -> Optional[str]:
    return target.name if isinstance(target, ColumnSchema) else target


class RegressionOutput(ModelOutput):
    """Linear regression head: one Dense unit; ``predict`` squeezes it."""

    default_loss = "mse"

    def __init__(self, target=None, in_features: Optional[int] = None, seed: int = 0,
                 device=None, **kwargs):
        super().__init__(target=_target_name(target), **kwargs)
        self.to_call = Dense(1, seed=seed, in_features=in_features, device=device)

    def default_metrics(self):
        from ..metrics.base import RMSE

        return [RMSE(name=f"{self.target}/rmse" if self.target else "rmse")]

    def activation(self, logits):
        return _squeeze_last(logits)


class BinaryOutput(ModelOutput):
    """Binary classification head: emits logits (the loss takes them in its
    stable form); ``predict`` gives the sigmoid, squeezed to (B,)."""

    default_loss = "binary_crossentropy"

    def __init__(self, target=None, in_features: Optional[int] = None, seed: int = 0,
                 device=None, **kwargs):
        super().__init__(target=_target_name(target), **kwargs)
        self.to_call = Dense(1, seed=seed, in_features=in_features, device=device)

    def default_metrics(self):
        from ..metrics.base import AUC, BinaryAccuracy, Precision, Recall

        p = f"{self.target}/" if self.target else ""
        return [BinaryAccuracy(name=f"{p}binary_accuracy"), Precision(name=f"{p}precision"),
                Recall(name=f"{p}recall"), AUC(name=f"{p}auc")]

    def activation(self, logits):
        return _squeeze_last(torch.sigmoid(logits))


class CategoricalTarget(Block):
    """Dense projection to the classes' logits."""

    def __init__(self, num_classes: int, use_bias: bool = True, seed: int = 0,
                 in_features: Optional[int] = None, device=None):
        super().__init__()
        self.dense = Dense(num_classes, use_bias=use_bias, seed=seed, in_features=in_features,
                           device=device)
        self.num_classes = num_classes

    def forward(self, inputs, **kwargs):
        return self.dense(inputs)


class _ShardLogits(torch.autograd.Function):
    """``x @ shard.T`` on each rank of a model line (``g``), the columns
    all-gathered over it into the whole catalog's logits. The backward takes
    this rank's own columns of the cotangent: the shard's gradient is
    ``own.T @ x``, all-reduced over the data line (``dg``, where the batch is
    split over it; one collective of the shard's size, whatever the batch)
    and divided by its size; the queries' gradient is ``own @ shard``, summed
    over the model line."""

    @staticmethod
    def forward(ctx, x, shard, g, dg):
        from ..parallel.collectives import all_gather

        ctx.save_for_backward(x, shard)
        ctx.g, ctx.dg = g, dg
        part = x @ shard.T  # (N, R / n)
        return all_gather(part.T.contiguous(), g).T

    @staticmethod
    def backward(ctx, grad):
        from ..parallel.collectives import all_reduce

        x, shard = ctx.saved_tensors
        g, dg = ctx.g, ctx.dg
        rows = shard.shape[0]
        own = grad[:, g.index * rows:(g.index + 1) * rows]
        gx = all_reduce(own @ shard, g)
        gw = own.T @ x
        if dg is not None:
            gw = all_reduce(gw, dg) / dg.size
        return gx, gw, None, None


class EmbeddingTablePrediction(Block):
    """Weight tying: the logits are ``x @ table.T`` over the table's
    ``input_dim`` rows (the catalog), the operands in the policy's compute
    dtype, the result float32. ``embedding_lookup`` gathers the table's rows
    as its input lookups do (``EmbeddingTable._lookup``)."""

    def __init__(self, table):
        super().__init__()
        self.table = table

    def forward(self, inputs, *, training=False, context=None, **kwargs):
        if training and context is not None and context.get("sparse_lookups") is not None:
            raise ValueError(
                "Full-catalog weight-tying softmax produces dense table gradients, "
                "incompatible with the row-sparse embedding optimizer. Use sampled "
                "softmax (ContrastiveOutput) or a dense optimizer for this table.")
        if isinstance(inputs, SequenceFeature):
            inputs = inputs.values
        shard = getattr(self.table, "shard", None)
        if shard is not None:
            return self._sharded_logits(inputs, shard, context)
        return cast_compute(inputs).float() @ cast_compute(self.table.embeddings).float().T

    def _sharded_logits(self, inputs, shard, context):
        """The logits over a table split by rows over a mesh: each rank
        scores its shard's rows and the columns are gathered over the model
        line (the same queries on every rank of it); :class:`_ShardLogits`
        gives the backward. In a mesh step the shard's gradient is the
        global batch's."""
        from ..parallel.mesh import DATA_AXIS

        mesh = shard.mesh
        in_step = context is not None and context.get("mesh") is not None
        dg = mesh.group(DATA_AXIS) if in_step else None
        x = cast_compute(inputs).float()
        w = cast_compute(self.table.table).float()
        flat = x.reshape(-1, x.shape[-1])
        logits = _ShardLogits.apply(flat, w, mesh.group(shard.axis),
                                    dg if dg is not None and dg.size > 1 else None)
        return logits.reshape(*x.shape[:-1], -1)[..., : self.table.input_dim]

    def embedding_lookup(self, ids: torch.Tensor, site: str = "tying",
                         context=None) -> torch.Tensor:
        """The table's rows at ``ids``; on the row-sparse route recorded
        under ``site`` (``"pos"``, ``"neg"``), as the JAX package taps them."""
        return self.table._lookup(ids, context, site)

    @property
    def num_classes(self) -> int:
        return self.table.input_dim


class CategoricalOutput(ModelOutput):
    """Multi-class head over a categorical column (its cardinality), a
    number of classes, or an :class:`EmbeddingTable` (weight tying: the
    logits are ``x @ table.T``, the target the table's first column; no
    ``in_features``); ``predict`` gives the softmax."""

    default_loss = "sparse_categorical_crossentropy"

    def __init__(self, to_call, in_features: Optional[int] = None, target: Optional[str] = None,
                 default_metrics_top_ks: Sequence[int] = (10,), seed: int = 0, device=None,
                 **kwargs):
        from ..inputs.embedding import EmbeddingTable

        head = None
        if isinstance(to_call, ColumnSchema):
            target = target or to_call.name
            num_classes = to_call.cardinality
        elif isinstance(to_call, int):
            num_classes = to_call
        elif isinstance(to_call, EmbeddingTable):
            target = target or to_call.features[0]
            head = EmbeddingTablePrediction(to_call)
            num_classes = head.num_classes
        else:
            raise TypeError("CategoricalOutput takes a column, a number of classes or an "
                            f"EmbeddingTable, not {type(to_call).__name__}")
        super().__init__(target=target, **kwargs)
        self.num_classes = num_classes
        self.top_ks = tuple(default_metrics_top_ks)
        self.to_call = head if head is not None else CategoricalTarget(
            num_classes, seed=seed, in_features=in_features, device=device)

    def default_metrics(self):
        from ..metrics.topk import TopKMetricsAggregator

        return [TopKMetricsAggregator.default(k) for k in self.top_ks]

    def activation(self, logits):
        return torch.softmax(logits, dim=-1)


class DotProduct(Block):
    """The row-wise dot of a dict's query and candidate, (B, 1)."""

    def __init__(self, query_name: str = "query", candidate_name: str = "candidate"):
        super().__init__()
        self.query_name = query_name
        self.candidate_name = candidate_name

    def forward(self, inputs: dict, **kwargs):
        return (inputs[self.query_name] * inputs[self.candidate_name]).sum(dim=-1, keepdim=True)


class ColumnBasedSampleWeight(Block):
    """A head's ``post``: sample weights from a feature or target column,
    or binary class weights ``(negative, positive)`` by its value; they
    multiply the weights the Prediction already has."""

    def __init__(self, weight_column_name: str,
                 binary_class_weights: Optional[Tuple[float, float]] = None):
        super().__init__()
        self.weight_column_name = weight_column_name
        self.binary_class_weights = binary_class_weights

    def compute_weight(self, col: torch.Tensor) -> torch.Tensor:
        col = col.to(torch.float32)
        if self.binary_class_weights is not None:
            neg_w, pos_w = self.binary_class_weights
            return torch.where(col > 0, pos_w, neg_w)
        return col

    def forward(self, inputs, *, context=None, targets=None, **kwargs):
        col = context.features.get(self.weight_column_name) if context is not None else None
        if col is None and isinstance(targets, dict):
            col = targets.get(self.weight_column_name)
        if col is None:
            raise ValueError(f"Column {self.weight_column_name!r} not found for sample weights")
        w = self.compute_weight(col)
        if isinstance(inputs, Prediction):
            prev = inputs.sample_weight
            return inputs._replace(sample_weight=w if prev is None else w * prev)
        return inputs


def OutputBlock(schema: Schema, in_features: Optional[int] = None,
                task_blocks: Optional[Dict[str, nn.Module]] = None,
                logits_temperature: float = 1.0, device=None) -> Block:
    """Heads from the schema's TARGET columns: regression (a REGRESSION tag,
    or a float column not tagged binary) → :class:`RegressionOutput`; a
    MULTI_CLASS_CLASSIFICATION int column → :class:`CategoricalOutput`;
    otherwise :class:`BinaryOutput`. One head is returned as it is, several
    as a :class:`ParallelBlock` of heads by name (a dict of Predictions).
    ``task_blocks`` gives a target its own tower (the head's ``pre``, with
    an ``out_features``)."""
    targets = schema.targets
    if not len(targets):
        raise ValueError("Schema has no TARGET-tagged columns")
    heads: Dict[str, ModelOutput] = {}
    for col in targets:
        tower = (task_blocks or {}).get(col.name)
        # a tower's width builds the head now only where its device is known
        kw = dict(logits_temperature=logits_temperature, device=device,
                  in_features=(getattr(tower, "out_features", None) if device is not None
                               else None) if tower is not None else in_features)
        if tower is not None:
            kw["pre"] = tower
        if col.has_tag(Tags.REGRESSION) or (
                col.dtype.startswith("float") and not col.has_tag(Tags.BINARY_CLASSIFICATION)):
            head = RegressionOutput(col.name, **kw)
        elif col.has_tag(Tags.MULTI_CLASS_CLASSIFICATION) and col.int_domain:
            head = CategoricalOutput(col, **kw)
        else:
            head = BinaryOutput(col.name, **kw)
        heads[head.block_name] = head
    if len(heads) == 1:
        return next(iter(heads.values()))
    return ParallelBlock(heads, block_name="output_block")
