"""Model: a sequential container ending in a head, with ``predict``,
``compile`` and ``fit`` (the subset of ``models_tpu/models/base.py`` that the
two-tower model serves and trains with).

Training steps run eagerly, one batch at a time: the forward with
``need_logits`` False (no metric reads the logits, so the contrastive head
takes its fused loss), the backward, and one optimizer step. Not ported yet
(ROADMAP.md queue 1): training metrics and ``evaluate``,
``steps_per_execution``, device-resident epochs, meshes, callbacks, the
row-sparse embedding optimizer and frozen blocks.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..blocks.optimizer import check_optimizer, make_optimizer
from ..core.block import Block
from ..core.device import check_module_device
from ..core.types import (ModelContext, Prediction, TopKPrediction, to_device_batch,
                          to_device_targets)
from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader
from ..losses import categorical_crossentropy, get_loss, sparse_categorical_crossentropy
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
                learning_rate: Optional[float] = None, train_metrics_steps: int = 1) -> "Model":
        """Choose the optimizer, the loss (a name, a callable, or a dict by
        head name or target; None takes each head's default) and the metrics.
        ``metrics=None`` means the top-k training metrics, which are not ported
        yet: pass ``metrics=[]``. Optimizer slots and the step count live until
        the next ``compile()``."""
        if metrics is None:
            raise NotImplementedError(
                "compile(metrics=None) asks for the top-k training metrics, which are not "
                "ported yet (ROADMAP.md queue 1): pass metrics=[]")
        if len(metrics):
            raise NotImplementedError("training metrics are not ported yet "
                                      "(ROADMAP.md queue 1): pass metrics=[]")
        if train_metrics_steps < 1:
            raise ValueError(f"train_metrics_steps must be >= 1, got {train_metrics_steps}")
        check_optimizer(optimizer)
        self._optimizer_name = optimizer
        self._learning_rate = learning_rate
        self._loss_spec = loss
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

    def train_step(self, x: Dict[str, torch.Tensor], y, loss_fns) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the model's device: forward, backward,
        optimizer step. Returns the step's logs, detached, on the device."""
        context = ModelContext(features=x, targets=y, step=self._step, need_logits=False)
        preds = self(x, targets=y, training=True, context=context)
        total, logs = self._compute_losses(self._as_pred_dict(preds), x, loss_fns)
        self._optimizer.zero_grad(set_to_none=True)
        total.backward()
        self._optimizer.step()
        self._step += 1
        return {k: v.detach() for k, v in logs.items()}

    def fit(self, data: Union[Dataset, Loader], epochs: int = 1,
            batch_size: Optional[int] = None, shuffle: bool = True, device=None) -> History:
        """Train for ``epochs`` passes over ``data`` in full batches (the
        loader drops the last partial one). ``history[name]`` holds each
        epoch's mean step log, plus ``examples_per_sec`` (host clock)."""
        if not self._compiled:
            self.compile()
        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(
            data, batch_size or 1024, drop_last=True, shuffle=shuffle)
        loss_fns = self._resolve_task_losses()
        if self._optimizer is None:
            self._optimizer = make_optimizer(
                self._optimizer_name, [p for p in self.parameters() if p.requires_grad],
                self._learning_rate)
        history = History()
        for _ in range(epochs):
            t0 = time.perf_counter()
            step_logs: Dict[str, List[torch.Tensor]] = {}
            n_examples = 0
            for x, y in loader:
                logs = self.train_step(to_device_batch(x, dev), to_device_targets(y, dev),
                                       loss_fns)
                for k, v in logs.items():
                    step_logs.setdefault(k, []).append(v)
                n_examples += loader.batch_size
            names = sorted(step_logs)
            means = (torch.stack([torch.stack(step_logs[k]).mean() for k in names]).cpu()
                     if names else [])  # one copy to the host per epoch
            epoch_logs = dict(zip(names, (float(v) for v in means)))
            epoch_logs["examples_per_sec"] = n_examples / max(time.perf_counter() - t0, 1e-9)
            history.append(epoch_logs)
        self.history = history
        return history
