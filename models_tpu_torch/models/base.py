"""Model: a sequential container ending in a head, with ``predict``,
``compile``, ``fit`` and ``evaluate`` (the subset of
``models_tpu/models/base.py`` that the two-tower model serves, trains and
evaluates with).

Training steps run eagerly, one batch at a time: the forward, the backward,
one dense optimizer step, and, with ``compile(embedding_optimizer=...)``, one
row-sparse update of each routed table per lookup (``blocks/optimizer.py``).
A step that feeds the metrics (every ``train_metrics_steps``-th) runs the
forward with ``need_logits`` True, so that the contrastive head returns its
logits; the others with False, so that it takes its fused loss. Metric states
stay on the device; each epoch (and each ``evaluate``) copies its losses and
metric results to the host once. Not ported yet (ROADMAP.md queue 1):
``steps_per_execution``, device-resident epochs, meshes, callbacks,
``MultiOptimizer``, the sharded sparse update and frozen blocks.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..blocks.optimizer import (SparseEmbeddingOptimizer, check_optimizer,
                                low_precision_optimizer_state, make_optimizer,
                                split_embeddings_on_size, state_dtype)
from ..core.block import Block
from ..core.device import check_module_device
from ..core.types import (ModelContext, Prediction, TopKPrediction, to_device_batch,
                          to_device_targets)
from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader
from ..inputs.embedding import EmbeddingTable
from ..losses import categorical_crossentropy, get_loss, sparse_categorical_crossentropy
from ..metrics.base import Metric
from ..metrics.topk import TopKMetric, TopKMetricsAggregator
from ..outputs.base import ModelOutput


def _auto_loss(loss_fn: Callable, labels, logits, sample_weight):
    """Integer labels with the dense categorical CE take the sparse one."""
    if loss_fn is categorical_crossentropy and labels is not None:
        if labels.ndim == logits.ndim - 1 or (
            labels.ndim == logits.ndim and labels.shape[-1] == 1 and logits.shape[-1] > 1
        ):
            return sparse_categorical_crossentropy(labels, logits, sample_weight)
    return loss_fn(labels, logits, sample_weight)


def _merge_row_valid(sw, row_valid):
    """The head's sample weights times the loader's row validity."""
    if row_valid is None:
        return sw
    rv = row_valid.to(torch.float32)
    if sw is None:
        return rv
    return sw * rv.reshape(rv.shape + (1,) * (sw.ndim - 1))


def _fetch(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalars to the host in one copy."""
    if not values:
        return {}
    names = sorted(values)
    host = torch.stack([values[n].detach().reshape(()).to(torch.float32) for n in names]).cpu()
    return {n: float(v) for n, v in zip(names, host)}


class History:
    """``history[name]``: one value per epoch, the mean over its steps."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, logs: Dict[str, float]):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))

    def __repr__(self):
        return f"History({ {k: [round(x, 4) for x in v] for k, v in self.history.items()} })"


class Model(Block):
    def __init__(self, *blocks: nn.Module):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        for b in blocks:
            if getattr(b, "schema", None) is not None:
                self.schema = b.schema
                break
        self._compiled = False

    def forward(self, inputs, **kwargs):
        kwargs.setdefault("context", ModelContext(features=inputs))
        out = inputs
        for block in self.blocks:
            out = block(out, **kwargs)
        return out

    def heads(self) -> List[ModelOutput]:
        return [m for m in self.modules() if isinstance(m, ModelOutput)]

    @staticmethod
    def _outputs(preds):
        if isinstance(preds, TopKPrediction):
            return {"scores": preds.scores, "ids": preds.identifiers}
        if isinstance(preds, Prediction):
            return preds.outputs
        return preds

    @torch.no_grad()
    def predict(self, data: Union[Dataset, Loader], batch_size: Optional[int] = None,
                device=None):
        """Run the model over the data in batches and drop padded rows. A top-k
        model returns ``{"scores": (n, k) f32, "ids": (n, k) int32}`` as numpy."""
        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size or 1024)
        chunks = []
        for x, _ in loader:
            out = self._outputs(self(to_device_batch(x, dev)))
            valid = x[ROW_VALID_KEY]
            if isinstance(out, dict):
                chunks.append({k: v.cpu().numpy()[valid] for k, v in out.items()})
            else:
                chunks.append(out.cpu().numpy()[valid])
        if not chunks:
            return None
        if isinstance(chunks[0], dict):
            return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        return np.concatenate(chunks)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def compile(self, optimizer: str = "adam", loss=None, metrics=None,
                learning_rate: Optional[float] = None, train_metrics_steps: int = 1,
                embedding_optimizer: Union[None, str, SparseEmbeddingOptimizer] = None,
                sparse_threshold: Optional[int] = None,
                optimizer_state_dtype: Union[None, str, torch.dtype] = None) -> "Model":
        """Choose the optimizer, the loss (a name, a callable, or a dict by
        head name or target; None takes each head's default) and the metrics
        (None takes each head's default, the top-k metrics @10 for the
        retrieval heads; a name, a :class:`Metric`, a list of them, or a dict
        by head name or target; ``[]`` none). Training updates the metrics on
        every ``train_metrics_steps``-th step. The dense optimizer's slots and
        the step count live until the next ``compile()``.

        ``embedding_optimizer`` (a :class:`SparseEmbeddingOptimizer`, or its
        kind: ``"sgd"``, ``"adagrad"``, ``"adam"``, also as ``"lazy_adam"`` or
        ``"sparse_adagrad"``, at ``learning_rate``, default 0.05) trains the
        embedding tables row-sparsely; the dense optimizer takes the rest. With
        ``sparse_threshold``, only tables of more than that many rows, and
        every bf16 table, go to it. Its slots live on the tables.
        ``optimizer_state_dtype`` (e.g. ``"bfloat16"``) stores the dense
        optimizer's slots in that dtype at rest
        (:func:`~models_tpu_torch.blocks.optimizer.low_precision_optimizer_state`);
        the row-sparse slots stay float32."""
        if train_metrics_steps < 1:
            raise ValueError(f"train_metrics_steps must be >= 1, got {train_metrics_steps}")
        check_optimizer(optimizer)
        if isinstance(embedding_optimizer, str):
            kind = embedding_optimizer.replace("lazy_", "").replace("sparse_", "")
            embedding_optimizer = SparseEmbeddingOptimizer(
                kind, learning_rate=0.05 if learning_rate is None else learning_rate)
        elif not isinstance(embedding_optimizer, (SparseEmbeddingOptimizer, type(None))):
            raise TypeError("embedding_optimizer must be a SparseEmbeddingOptimizer or its "
                            f"kind, not {type(embedding_optimizer).__name__}")
        self._emb_opt = embedding_optimizer
        self._sparse_threshold = sparse_threshold
        self._sparse_tables: List[EmbeddingTable] = []
        self._optimizer_name = optimizer
        self._optimizer_state_dtype = (None if optimizer_state_dtype is None
                                       else state_dtype(optimizer_state_dtype))
        self._learning_rate = learning_rate
        self._loss_spec = loss
        self._metrics_spec = metrics
        self.train_metrics_steps = train_metrics_steps
        self._optimizer = None
        self._step = 0
        self._compiled = True
        return self

    def _resolve_task_losses(self) -> Dict[str, Callable]:
        out: Dict[str, Callable] = {}
        for head in self.heads():
            spec = self._loss_spec
            if isinstance(spec, dict):
                spec = spec.get(head.block_name) or spec.get(head.target)
            if spec is not None:
                out[head.block_name] = get_loss(spec)
            elif head.default_loss is not None:
                out[head.block_name] = get_loss(head.default_loss)
        return out

    def _resolve_task_metrics(self) -> Dict[str, List[Metric]]:
        out: Dict[str, List[Metric]] = {}
        for head in self.heads():
            spec = self._metrics_spec
            if isinstance(spec, dict):
                spec = spec.get(head.block_name) or spec.get(head.target)
            if spec is None:
                out[head.block_name] = head.default_metrics()
            else:
                if not isinstance(spec, (list, tuple)):
                    spec = [spec]
                out[head.block_name] = [Metric.parse(m) for m in spec]
        return out

    @staticmethod
    def _init_metric_states(task_metrics, device) -> Dict[str, list]:
        return {name: [m.init_state(device) for m in ms] for name, ms in task_metrics.items()}

    @torch.no_grad()
    def _update_metrics(self, states, pred_dict, x, task_metrics) -> None:
        """Each head's metrics over the batch's valid rows; ``states`` is
        updated in place. Integer targets become one-hot relevance."""
        row_valid = x.get(ROW_VALID_KEY)
        for name, ms in task_metrics.items():
            pred = pred_dict.get(name)
            if pred is None or pred.targets is None:
                continue
            outputs, t = pred.outputs.detach(), pred.targets
            sw = _merge_row_valid(pred.sample_weight, row_valid)
            for i, m in enumerate(ms):
                if isinstance(m, (TopKMetric, TopKMetricsAggregator)):
                    if t.ndim == outputs.ndim - 1:
                        t = torch.nn.functional.one_hot(t.long(), outputs.shape[-1])
                    states[name][i] = m.update(states[name][i], outputs, t, sample_weight=sw,
                                               label_relevant_counts=pred.label_relevant_counts)
                else:
                    states[name][i] = m.update(states[name][i], outputs, t, sample_weight=sw)

    @staticmethod
    def _metric_results(states, task_metrics) -> Dict[str, torch.Tensor]:
        """Every metric's result, on the device; with several heads a key is
        prefixed with its head's name."""
        multi = len(task_metrics) > 1
        out: Dict[str, torch.Tensor] = {}
        for name, ms in task_metrics.items():
            for m, st in zip(ms, states[name]):
                res = m.result(st)
                mname = getattr(m, "reported_name", m.name)
                if isinstance(res, dict):
                    for k, v in res.items():
                        out[f"{name}/{k}" if multi else k] = v
                else:
                    out[f"{name}/{mname}" if multi and "/" not in mname else mname] = res
        return out

    def _as_pred_dict(self, preds) -> Dict[str, Prediction]:
        if isinstance(preds, Prediction):
            heads = self.heads()
            return {heads[0].block_name if heads else "output": preds}
        if isinstance(preds, dict):
            return {k: v for k, v in preds.items() if isinstance(v, Prediction)}
        raise TypeError(f"Model produced {type(preds)}; expected Prediction or dict")

    def _compute_losses(self, pred_dict, x, loss_fns):
        """(total, logs): each head's loss under ``loss/<head>``, their sum
        under ``loss``. A fused head's loss has its weights folded in."""
        row_valid = x.get(ROW_VALID_KEY)
        logs: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=row_valid.device if row_valid is not None else None)
        for name, pred in pred_dict.items():
            if pred.precomputed_loss is not None:
                value = pred.precomputed_loss
            elif pred.targets is None or name not in loss_fns:
                continue
            else:
                sw = _merge_row_valid(pred.sample_weight, row_valid)
                value = _auto_loss(loss_fns[name], pred.targets, pred.outputs, sw)
            logs[f"loss/{name}"] = value
            total = total + value
        # no regularizer is ported yet (every table's l2_reg is 0)
        logs["regularization_loss"] = torch.zeros_like(total)
        logs["loss"] = total
        return total, logs

    # ------------------------------------------------------------------
    # row-sparse embedding training
    # ------------------------------------------------------------------
    def _embedding_tables(self) -> List[EmbeddingTable]:
        return [m for m in self.modules() if isinstance(m, EmbeddingTable)]

    def _setup_sparse_embeddings(self) -> List[EmbeddingTable]:
        """Route the tables and return the row-sparse ones, with slots (kept
        when they already have the optimizer's). Without an embedding
        optimizer none; without a threshold all; with one, the tables of more
        rows than it and every bf16 table (stochastic rounding exists only on
        the scatter path)."""
        tables = self._embedding_tables()
        lowp = [t for t in tables if t.table.dtype != torch.float32]
        if self._emb_opt is None:
            if lowp:
                raise ValueError(
                    f"Low-precision embedding tables ({[t.block_name for t in lowp]}) train "
                    "via stochastic-rounding scatter updates: compile() with a sparse "
                    'embedding_optimizer (e.g. embedding_optimizer="adagrad"); the dense '
                    "optimizer would round to nearest in bf16 and silently drop small updates")
            routed = []
        elif not tables:
            raise ValueError("embedding_optimizer was set but the model has no embedding tables")
        elif self._sparse_threshold is None:
            routed = tables
        else:
            large, _ = split_embeddings_on_size(tables, self._sparse_threshold)
            routed = [t for t in tables if t in large or t in lowp]
            if not routed:
                warnings.warn(f"sparse_threshold={self._sparse_threshold} routed every "
                              "embedding table to the dense optimizer: drop "
                              "embedding_optimizer or lower the threshold", stacklevel=3)
        for t in tables:
            t.sparse_routed = t in routed
            slots = t.sparse_slots
            if t.sparse_routed and (slots is None or sorted(slots.keys())
                                    != sorted(self._emb_opt.slot_names())):
                self._emb_opt.init_slots(t)
        return routed

    def _apply_sparse(self, lookups) -> None:
        """One row-sparse update per lookup: table by table, each in the order
        of its lookups in the forward (the JAX package's order). A table that
        serves two columns takes two updates."""
        for table in self._sparse_tables:
            for t, ids, rows in lookups:
                if t is table:
                    grad = rows.grad if rows.grad is not None else torch.zeros_like(rows)
                    self._emb_opt.apply(table, ids, grad, self._step)

    def train_step(self, x: Dict[str, torch.Tensor], y, loss_fns,
                   mark: Optional[Callable[[str], None]] = None,
                   task_metrics=None, metric_states=None) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the model's device: forward, backward,
        dense optimizer step, row-sparse updates. Returns the step's logs,
        detached, on the device. With ``metric_states`` the step feeds the
        metrics: the heads return their logits (``need_logits``) and the
        states of ``task_metrics`` are updated in place. ``mark``, where
        given, is called with the name of each part as its work is queued
        (``loss_forward``, ``backward``, ``optimizer``, ``sparse_update``), so
        that a caller can time the parts."""
        mark = mark or (lambda name: None)
        with_metrics = metric_states is not None
        context = ModelContext(features=x, targets=y, step=self._step, need_logits=with_metrics)
        if self._sparse_tables:
            context["sparse_lookups"] = []
        preds = self(x, targets=y, training=True, context=context)
        pred_dict = self._as_pred_dict(preds)
        total, logs = self._compute_losses(pred_dict, x, loss_fns)
        if with_metrics:
            self._update_metrics(metric_states, pred_dict, x, task_metrics)
        mark("loss_forward")
        self._optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        self._optimizer.step()
        mark("optimizer")
        if self._sparse_tables:
            self._apply_sparse(context["sparse_lookups"])
        mark("sparse_update")
        self._step += 1
        return {k: v.detach() for k, v in logs.items()}

    def fit(self, data: Union[Dataset, Loader], epochs: int = 1,
            batch_size: Optional[int] = None, shuffle: bool = True,
            validation_data: Union[None, Dataset, Loader] = None, validation_freq: int = 1,
            device=None) -> History:
        """Train for ``epochs`` passes over ``data`` in full batches (the
        loader drops the last partial one). ``history[name]`` holds each
        epoch's mean step log, the metrics over its metric steps, plus
        ``examples_per_sec`` (host clock); with ``validation_data``, every
        ``validation_freq``-th epoch adds :meth:`evaluate`'s results under
        ``val_<name>``."""
        if not self._compiled:
            self.compile()
        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(
            data, batch_size or 1024, drop_last=True, shuffle=shuffle)
        loss_fns = self._resolve_task_losses()
        task_metrics = self._resolve_task_metrics()
        has_metrics = any(task_metrics.values())
        if self._optimizer is None:
            self._sparse_tables = self._setup_sparse_embeddings()
            routed = {id(t.table) for t in self._sparse_tables}
            self._optimizer = make_optimizer(
                self._optimizer_name,
                [p for p in self.parameters() if p.requires_grad and id(p) not in routed],
                self._learning_rate)
            if self._optimizer_state_dtype is not None:
                self._optimizer = low_precision_optimizer_state(self._optimizer,
                                                                self._optimizer_state_dtype)
        history = History()
        for epoch in range(epochs):
            t0 = time.perf_counter()
            states = self._init_metric_states(task_metrics, dev)
            step_logs: Dict[str, List[torch.Tensor]] = {}
            n_examples = 0
            for x, y in loader:
                metric_step = has_metrics and self._step % self.train_metrics_steps == 0
                logs = self.train_step(to_device_batch(x, dev), to_device_targets(y, dev),
                                       loss_fns, task_metrics=task_metrics,
                                       metric_states=states if metric_step else None)
                for k, v in logs.items():
                    step_logs.setdefault(k, []).append(v)
                n_examples += loader.batch_size
            values = {k: torch.stack(v).mean() for k, v in step_logs.items()}
            values.update(self._metric_results(states, task_metrics))
            epoch_logs = _fetch(values)  # one copy to the host per epoch
            epoch_logs["examples_per_sec"] = n_examples / max(time.perf_counter() - t0, 1e-9)
            if validation_data is not None and (epoch + 1) % validation_freq == 0:
                val = self.evaluate(validation_data, batch_size=batch_size or loader.batch_size,
                                    device=dev)
                epoch_logs.update({f"val_{k}": v for k, v in val.items()})
            history.append(epoch_logs)
        self.history = history
        return history

    @torch.no_grad()
    def evaluate(self, data: Union[Dataset, Loader], batch_size: Optional[int] = None,
                 steps: Optional[int] = None, device=None) -> Dict[str, float]:
        """The loss and the metrics over ``data`` (every row, the last batch
        padded and its padding masked; at most ``steps`` batches): the heads
        take their evaluation branch (``testing``), the contrastive head
        scoring each batch's in-batch negatives, the top-k head the catalog.
        ``loss`` is the mean of the batches' losses. One copy to the host."""
        if not self._compiled:
            self.compile()
        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size or 1024)
        loss_fns = self._resolve_task_losses()
        task_metrics = self._resolve_task_metrics()
        states = self._init_metric_states(task_metrics, dev)
        loss_total = torch.zeros((), device=dev)
        n_batches = 0
        for step, (x, y) in enumerate(loader):
            if steps is not None and step >= steps:
                break
            xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
            context = ModelContext(features=xb, targets=yb, testing=True, need_logits=True)
            preds = self(xb, targets=yb, training=False, context=context)
            pred_dict = self._as_pred_dict(preds)
            total, _ = self._compute_losses(pred_dict, xb, loss_fns)
            self._update_metrics(states, pred_dict, xb, task_metrics)
            loss_total = loss_total + total
            n_batches += 1
        values = {"loss": loss_total / max(n_batches, 1)}
        values.update(self._metric_results(states, task_metrics))
        results = _fetch(values)
        return {"loss": results.pop("loss"), **results}
