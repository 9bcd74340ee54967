"""Model: a sequential container ending in a head (or a block of heads),
with ``predict``, ``compile``, ``fit`` and ``evaluate`` (the subset of
``models_tpu/models/base.py`` that the two-tower, ranking, session and
multi-task models serve, train and evaluate with; each takes a ``pre=``
transform), on :class:`BaseModel`; :class:`ModelBlock` makes any block a
model.
``predict`` gives each head's ``activation`` of its logits (probabilities
for a binary head); ``compile`` takes each head's default loss and
metrics. Blocks that keep state across steps (BatchNorm's
running statistics) update it in place in the training forward, so that a
captured chunk replays it; a block whose state the backward may still read
(a cross-batch queue's ring) records its new state in the context's
``state_updates``, which the step writes in place after the optimizer.
The loss adds each block's ``regularization_loss`` (an embedding table's
``l2_reg``).

A training step runs the forward, the backward, one dense optimizer step,
and, with ``compile(embedding_optimizer=...)``, one row-sparse update of
each routed table per lookup (``blocks/optimizer.py``). A step that feeds
the metrics (every ``train_metrics_steps``-th) runs the forward with
``need_logits`` True, so that the contrastive head returns its logits; the
others with False, so that it takes its fused loss. Metric states stay on
the device; each epoch (and each ``evaluate``) copies its losses and metric
results to the host once.

``compile(steps_per_execution=k)`` runs k steps a chunk, as the JAX package
does, and only without an embedding optimizer (the row-sparse step stays one
step at a time). Where the dataset's columns fit (at most 2 GiB packed),
``fit`` packs them into one (n, F) int32 matrix, uploads it once (cached on
the dataset, for at most two datasets) with every epoch's permutation, and
each chunk gathers its permuted rows on the device (K9) and slices its
batches from them; otherwise it packs k host batches at a time and runs the
leftover batches one step each. On CUDA with ``compile(jit=True)`` each chunk
is one CUDA graph replay (``models/step_graph.py``); on the CPU, and with
``jit=False``, the same chunk runs eagerly. Under ``Loader(pad="bucket")``
each length bucket's rows form a group with its own pack and graphs
(:meth:`Model.fit`). A head over sequences flattens a batch's B * L
positions into rows: the loader's row validity repeats over them
(``_merge_row_valid``), and (B, L, C) outputs flatten for the metrics.

``evaluate`` goes device-resident where the JAX package's does (no ``pre``,
no mesh, ``jit``, every batch, one process's loader of every row at
``pad="max"``): the dataset's columns (at most 1 GiB) are packed once into
an eval pack padded with zero rows to whole batches (cached on the dataset,
for at most two datasets), and chunks of at most ``EVAL_CHUNK_BATCHES``
batches run the streaming route's step on slices of it, the padding masked
by the row validity; on CUDA under ``jit`` each chunk is a CUDA graph replay
(``_eval_graphs``), on the CPU the same chunk runs eagerly. ``fit(
validation_data=)`` validates through it, and where the JAX package fuses
validation into its epochs (the training pack, no callbacks, every epoch,
every batch) the validation chunks follow the epoch's last chunk, the two
logs fetched in one copy. Elsewhere ``fit`` (one step at a time) and
``evaluate`` stream, each batch copied to the device one batch ahead of its
step (``_device_prefetch``: pinned memory, a copy stream).

``fit(mesh=)`` trains on a mesh of ranks (``parallel/mesh.py``), one step at
a time as the JAX package does there, no step captured in a CUDA graph.
Every rank runs the same loader; each keeps its data slice of every batch
(``shard_batch``); the tables that the rules shard are split by rows over
the model axis and looked up by the all-to-all route. The mean loss over
the global batch is the mean of the ranks' losses (a weighted mean divides
by the data line's total weight: ``parallel/collectives.py::data_scope``),
and each gradient is that loss's: the dense parameters' gradients are
all-reduced over the world and divided by its size (the ranks of a model
line compute the same ones); a sharded table's gradient is made global in
its lookup's backward, which gathers the (ids, row gradients) of the data
line and never the shard; a row-sparse table's (ids, row gradients) are
gathered over the data line before the owner-masked update. Metric states
and the logged losses are reduced over the data line once an epoch, so that
``fit``'s history and ``evaluate`` on a mesh are those of one device. The
first fit on a mesh checks that every rank holds the same weights.

The loss sums the heads' in sorted name order (the JAX package's jitted
step sorts them), each times its weight (``compile(loss_weights=)``, else a
``ParallelPredictionBlock``'s ``task_weight_dict``, else 1), a binary head's
rows weighted by ``compile(class_weight=)``. ``freeze_blocks`` takes a
block's parameters out of the next ``fit``'s optimizer (and its row-sparse
tables out of the sparse update); a fit with frozen blocks or a
:class:`~models_tpu_torch.blocks.optimizer.MultiOptimizer`, and the first
plain fit after one, starts from fresh optimizer slots and step 0, as the
JAX package's does (it rebuilds its transform), and so does a fit on
another mesh than the optimizer's (its ``fingerprint``).
"""

from __future__ import annotations

import time
import warnings
import weakref
from collections import deque
from itertools import islice
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..blocks.mlp import LazyMixin
from ..blocks.optimizer import (MultiOptimizer, SparseEmbeddingOptimizer, check_optimizer,
                                low_precision_optimizer_state, make_optimizer,
                                split_embeddings_on_size, state_dtype)
from ..core.block import Block, as_block, call_block
from ..core.device import check_module_device
from ..core.policy import get_dtype_policy
from ..core.types import (ModelContext, Prediction, SequenceFeature, TopKPrediction,
                          to_device_batch, to_device_targets)
from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader
from ..inputs.embedding import EmbeddingTable
from ..losses import categorical_crossentropy, get_loss, sparse_categorical_crossentropy
from ..metrics.base import Metric
from ..metrics.topk import TopKMetric, TopKMetricsAggregator
from ..ops.embedding_lookup import row_gather
from ..outputs.base import BinaryOutput, ModelOutput
from ..outputs.queue import apply_state_updates
from ..parallel import mesh as pmesh
from ..parallel.collectives import all_gather, all_reduce, all_reduce_tree, data_scope
from ..utils import trace
from .step_graph import ChunkGraphs, eval_tensors

# the datasets that keep a device-resident training pack: at most two
_TRAIN_PACK_LRU: deque = deque()
# the largest pack fit uploads (the JAX package's limit)
MAX_PACK_BYTES = 2 << 30
# the datasets that keep a device-resident eval pack: at most two
_EVAL_PACK_LRU: deque = deque()
# the largest eval pack evaluate uploads (the JAX package's limit)
MAX_EVAL_PACK_BYTES = 1 << 30
# the device prefetch's copy stream, one a device for the process: the
# caching allocator keeps a stream's freed blocks for that stream, so a
# stream taken anew each call would allocate its batches from no blocks
_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
# the batches an evaluation chunk runs (one CUDA graph replay on the card):
# an eval set of more batches takes chunks of this many and one shorter
# chunk for the rest, so at most two captures a (dataset, batch size)
EVAL_CHUNK_BATCHES = 64


class DevicePack(NamedTuple):
    """A dataset's columns on the device: ``packed`` (n, F) int32 and the
    ``spec`` that :meth:`Model._make_unpack` decodes a slice of it by."""

    n_rows: int
    spec: tuple
    packed: torch.Tensor


def _auto_loss(loss_fn: Callable, labels, logits, sample_weight):
    """Integer labels with the dense categorical CE take the sparse one."""
    if loss_fn is categorical_crossentropy and labels is not None:
        if labels.ndim == logits.ndim - 1 or (
            labels.ndim == logits.ndim and labels.shape[-1] == 1 and logits.shape[-1] > 1
        ):
            return sparse_categorical_crossentropy(labels, logits, sample_weight)
    return loss_fn(labels, logits, sample_weight)


def _keep_pack(ds: Dataset) -> None:
    """Note that ``ds`` keeps device-resident columns (its pack, or its
    bucket groups' packs): at most two datasets do, the least recently
    packed dropping theirs first."""
    _TRAIN_PACK_LRU.append(weakref.ref(ds))
    while len(_TRAIN_PACK_LRU) > 2:
        old = _TRAIN_PACK_LRU.popleft()()
        if old is not None and old is not ds:
            old._device_train_pack = old._device_bucket_groups = None


def _keep_eval_pack(ds: Dataset) -> None:
    """Note that ``ds`` keeps a device-resident eval pack: at most two
    datasets do, the least recently packed dropping theirs first (a dataset
    packed again, at another batch size, counts once)."""
    for ref in [r for r in _EVAL_PACK_LRU if r() is ds or r() is None]:
        _EVAL_PACK_LRU.remove(ref)
    _EVAL_PACK_LRU.append(weakref.ref(ds))
    while len(_EVAL_PACK_LRU) > 2:
        old = _EVAL_PACK_LRU.popleft()()
        if old is not None and old is not ds:
            old._device_eval_pack = None


def _batch_arrays(x, y) -> Tuple[tuple, List[np.ndarray]]:
    """A host batch's structure and its arrays in that order: ``features``
    (a dict of arrays and :class:`SequenceFeature`, each a list column's
    values then its mask) and ``targets`` (None, one of those or a dict of
    them). The structure names each feature and target and says which are
    list columns."""
    arrays: List[np.ndarray] = []

    def take(v) -> bool:
        if isinstance(v, SequenceFeature):
            arrays.extend((np.asarray(v.values), np.asarray(v.mask)))
            return True
        arrays.append(np.asarray(v))
        return False

    xs = tuple((k, take(v)) for k, v in x.items())
    ys = (tuple((k, take(v)) for k, v in y.items()) if isinstance(y, dict)
          else None if y is None else take(y))
    return (xs, ys), arrays


class _BatchLayout:
    """Where the arrays of host batches of one structure, dtypes and shapes
    lie in ONE uint8 buffer, each at a 16-byte aligned offset; ``SLOTS``
    such host buffers (pinned with ``pin``), allocated once and written in
    turn (:meth:`fill`); and the batch rebuilt as views of a buffer, that
    buffer or its copy on another device, one ``as_strided`` an array
    (:meth:`rebuild`). One buffer makes one copy a batch."""

    SLOTS = 2

    def __init__(self, structure: tuple, arrays: List[np.ndarray], pin: bool):
        self.structure = structure
        self.plan = []  # (dtype, shape, strides, offset in elements) an array
        offsets, total = [], 0
        for a in arrays:
            strides, n = [], 1
            for d in reversed(a.shape):
                strides.append(n)
                n *= d
            self.plan.append((torch.from_numpy(np.empty(0, a.dtype)).dtype, a.shape,
                              tuple(reversed(strides)), total // a.itemsize))
            offsets.append(total)
            total += -(-a.nbytes // 16) * 16
        self.nbytes = max(total, 16)
        self.dtypes = sorted({p[0] for p in self.plan}, key=str)
        self.hosts = [torch.empty(self.nbytes, dtype=torch.uint8, pin_memory=pin)
                      for _ in range(self.SLOTS)]
        self.views = [[host.numpy()[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
                       for a, off in zip(arrays, offsets)] for host in self.hosts]
        # the event of the copy that read each host buffer last (None: none)
        self.done: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._turn = 0

    def fill(self, arrays: List[np.ndarray]) -> int:
        """Write a batch's arrays into the next host buffer, once the copy
        that read it last has ended (``done``), and return its index."""
        i, self._turn = self._turn, (self._turn + 1) % self.SLOTS
        if self.done[i] is not None:
            self.done[i].synchronize()
        for view, a in zip(self.views[i], arrays):
            np.copyto(view, a)
        return i

    def rebuild(self, buf: torch.Tensor) -> tuple:
        """``(features, targets)`` as views of ``buf``, each array's dtype
        and shape kept."""
        typed = {dt: buf.view(dt) for dt in self.dtypes}
        it = iter([typed[dt].as_strided(shape, strides, off)
                   for dt, shape, strides, off in self.plan])

        def build(seq: bool):
            return SequenceFeature(next(it), next(it)) if seq else next(it)

        xs, ys = self.structure
        fx = {k: build(seq) for k, seq in xs}
        if isinstance(ys, tuple):
            return fx, {k: build(seq) for k, seq in ys}
        return fx, None if ys is None else build(ys)


def _device_prefetch(batches, dev: torch.device):
    """The host batches ``(features, targets)`` of ``batches`` on ``dev``,
    one batch ahead of the step that takes it (the JAX package's
    ``_device_prefetch`` at depth 1). On the card each batch's arrays are
    written into one of two pinned host buffers of its layout
    (:class:`_BatchLayout`, allocated once a layout) and sent in one
    ``non_blocking`` copy on the device's copy stream (``_COPY_STREAMS``),
    so that the next batch's copy overlaps this batch's step; the host
    writes a buffer again only after its last copy has ended, the step's
    stream waits on the copy's event before it reads the batch, and the
    device buffer is recorded on that stream, so that the allocator reuses
    it only after the step. On the CPU the batches are made one ahead and
    nothing is copied."""
    copy = None
    if dev.type == "cuda":
        copy = _COPY_STREAMS.get(dev)
        if copy is None:
            copy = _COPY_STREAMS[dev] = torch.cuda.Stream(dev)
    layouts: Dict[tuple, _BatchLayout] = {}

    def send(x, y):
        if copy is None:
            return (to_device_batch(x, dev), to_device_targets(y, dev)), None, None
        structure, arrays = _batch_arrays(x, y)
        key = (structure, tuple((a.dtype, a.shape) for a in arrays))
        layout = layouts.get(key)
        if layout is None:
            layout = layouts[key] = _BatchLayout(structure, arrays, pin=True)
        i = layout.fill(arrays)
        with torch.cuda.stream(copy):
            buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
            buf.copy_(layout.hosts[i], non_blocking=True)
            done = layout.done[i] = torch.cuda.Event()
            done.record(copy)
        return layout.rebuild(buf), buf, done

    def arrived(batch, buf, done):
        if done is not None:
            step = torch.cuda.current_stream(dev)
            step.wait_event(done)
            buf.record_stream(step)
        return batch

    ahead = deque()
    for x, y in batches:
        ahead.append(send(x, y))
        if len(ahead) > 1:
            yield arrived(*ahead.popleft())
    while ahead:
        yield arrived(*ahead.popleft())


def _unwrap_targets(pred: Prediction):
    """(targets, sample weights): a :class:`SequenceFeature` target gives
    its values, and its mask multiplies the weights."""
    t, sw = pred.targets, pred.sample_weight
    if isinstance(t, SequenceFeature):
        m = t.mask.to(torch.float32)
        sw = m if sw is None else sw * m
        t = t.values
    return t, sw


def _merge_row_valid(sw, row_valid, lead_dim: int):
    """The head's sample weights times the loader's row validity. Where the
    head's rows are a batch's flattened positions (``lead_dim`` = B * L
    against B rows), each row's validity repeats over its positions."""
    if row_valid is None:
        return sw
    rv = row_valid.to(torch.float32)
    if sw is None:
        if lead_dim != rv.shape[0] and lead_dim % rv.shape[0] == 0:
            rv = rv.repeat_interleave(lead_dim // rv.shape[0])
        return rv
    if sw.shape[0] == rv.shape[0]:
        return sw * rv.reshape(rv.shape + (1,) * (sw.ndim - 1))
    if sw.shape[0] % rv.shape[0] == 0:
        return sw * rv.repeat_interleave(sw.shape[0] // rv.shape[0])
    return sw


def _build_batch(data: Union[Dataset, Loader], cap: int = 32):
    """One batch of at most ``cap`` rows to build a model on, in row order:
    2 rows of a dataset, or the loader's batch size capped (the JAX
    package's ``sample_batch`` and ``_slice_build_batch``: only the batch
    axis is cut, so every width is the data's)."""
    if isinstance(data, Loader):
        loader = Loader(data.dataset, min(data.batch_size, cap), pad=data.pad, prefetch=0)
    else:
        loader = Loader(data, 2, prefetch=0)
    return next(iter(loader))


def _fetch(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Scalars to the host in one copy."""
    if not values:
        return {}
    trace.count("fetches")
    with trace.span("fetch"):
        names = sorted(values)
        host = torch.stack([values[n].detach().reshape(()).to(torch.float32)
                            for n in names]).cpu()
    return {n: float(v) for n, v in zip(names, host)}


def _upload(packed: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A packed matrix on ``dev``: the span ``pack.upload``, its bytes
    counted in ``h2d.bytes``."""
    trace.count("h2d.bytes", packed.nbytes)
    with trace.span("pack.upload"):
        return torch.as_tensor(packed, device=dev)


class History:
    """``history[name]``: one value per epoch, the mean over its steps."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, logs: Dict[str, float]):
        for k, v in logs.items():
            self.history.setdefault(k, []).append(float(v))

    def __repr__(self):
        return f"History({ {k: [round(x, 4) for x in v] for k, v in self.history.items()} })"


class BaseModel(Block):
    """The engine (``predict``, ``compile``, ``fit``, ``evaluate``, freezing)
    over a subclass's ``forward``."""

    _compiled = False
    _mesh = None

    def heads(self) -> List[ModelOutput]:
        return [m for m in self.modules() if isinstance(m, ModelOutput)]

    def unbuilt_layers(self) -> List[nn.Module]:
        """The layers that build at their first call and have not yet."""
        return [m for m in self.modules() if isinstance(m, LazyMixin) and not m.built]

    @torch.no_grad()
    def build(self, data, device=None) -> "BaseModel":
        """Build every layer left without its width (``blocks/mlp.py``'s
        ``LazyMixin``) in one eager forward, ``training=False``, on at most 32
        rows of a sample batch of ``data`` (a Dataset, a Loader, or a
        ``(features, targets)`` pair of host batches), on ``device`` (the
        model's; the default the card). A model with nothing to build runs
        nothing. ``fit``, ``evaluate`` and ``predict`` call it first, so
        that the parameters exist before the optimizer, the row-sparse slots
        and any captured graph."""
        if not self.unbuilt_layers():
            return self
        from ..utils.io import spec_of

        dev = check_module_device(self, device)
        if isinstance(data, (Dataset, Loader)):
            x, y = _build_batch(data)
        else:
            x, y = data if isinstance(data, tuple) else (data, None)
        # the batch's shapes, which load_model builds a fresh model on
        self._build_spec = spec_of((x, y))
        xb, yb = to_device_batch(x, dev), to_device_targets(y, dev)
        self(xb, targets=yb, training=False,
             context=ModelContext(features=xb, targets=yb))
        left = self.unbuilt_layers()
        if left:
            raise RuntimeError(f"the build pass left {len(left)} layers unbuilt "
                               f"({type(left[0]).__name__}): no input reached them")
        return self

    def _outputs(self, preds):
        """What ``predict`` returns of the model's output: each head's
        activation of its logits."""
        if isinstance(preds, TopKPrediction):
            return {"scores": preds.scores, "ids": preds.identifiers}
        heads = {h.block_name: h for h in self.heads()}
        if isinstance(preds, Prediction):
            head = next(iter(heads.values()), None)
            return head.activation(preds.outputs) if head is not None else preds.outputs
        if isinstance(preds, dict):
            return {k: heads[k].activation(v.outputs) if isinstance(v, Prediction) and k in heads
                    else v for k, v in preds.items()}
        return preds

    @torch.no_grad()
    def predict(self, data: Union[Dataset, Loader], batch_size: Optional[int] = None,
                pre: Optional[nn.Module] = None, device=None):
        """Run the model over the data in batches and drop padded rows: numpy
        arrays of each head's activation (a binary head's probabilities (n,),
        a regression head's values (n,), a tied head's full-catalog scores
        (n[, L], catalog); several heads: a dict by head name). A top-k
        model returns ``{"scores": (n, k) f32, "ids": (n, k) int32}``.
        ``pre``: a transform of each batch's features on the device first."""
        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size or 1024)
        self.build(loader, device=dev)
        chunks = []
        for x, y in loader:
            xb = to_device_batch(x, dev)
            if pre is not None:
                xb, _ = self._apply_pre(pre.to(dev), xb, to_device_targets(y, dev),
                                        training=False)
            out = self._outputs(self(xb))
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
    def compile(self, optimizer: Union[str, MultiOptimizer] = "adam", loss=None, metrics=None,
                loss_weights: Optional[Dict[str, float]] = None,
                learning_rate: Union[None, float, Callable] = None,
                train_metrics_steps: int = 1,
                embedding_optimizer: Union[None, str, SparseEmbeddingOptimizer] = None,
                sparse_threshold: Optional[int] = None, jit: bool = True,
                steps_per_execution: int = 1, class_weight: Optional[Dict] = None,
                optimizer_state_dtype: Union[None, str, torch.dtype] = None) -> "BaseModel":
        """Choose the optimizer (a name: adam, adamw, adagrad, adafactor,
        lamb, rmsprop, sgd; or a :class:`MultiOptimizer`), the loss (a name, a
        callable, or a dict by head name or target; None takes each head's
        default) and the metrics (None takes each head's default, the top-k
        metrics @10 for the retrieval heads; a name, a :class:`Metric`, a
        list of them, or a dict by head name or target; ``[]`` none).
        Training updates the metrics on every ``train_metrics_steps``-th
        step. The dense optimizer's slots and the step count live until the
        next ``compile()`` (or a fit that starts them afresh: the module's
        note). ``learning_rate``: a number, or a function of the step count
        (an int32 tensor on the device, 0 at the first step), evaluated
        inside each step (optax's schedules, written in torch ops).

        ``loss_weights``: a head's loss weight by its name or its bare
        target (``{"click/BinaryOutput": 1.0, "conversion": 0.5}``); a head
        it does not name takes its ``task_weight_dict`` weight, else 1.
        ``class_weight``: ``{0: w0, 1: w1}`` weighs every binary head's rows
        by their label, or ``{task: {0: w0, 1: w1}}`` by head name or target.
        Both enter a captured chunk as constants.

        ``embedding_optimizer`` (a :class:`SparseEmbeddingOptimizer`, or its
        kind: ``"sgd"``, ``"adagrad"``, ``"adam"``, also as ``"lazy_adam"`` or
        ``"sparse_adagrad"``, at ``learning_rate``, default 0.05) trains the
        embedding tables row-sparsely; the dense optimizer takes the rest. With
        ``sparse_threshold``, only tables of more than that many rows, and
        every bf16 table, go to it. Its slots live on the tables.
        ``optimizer_state_dtype`` (e.g. ``"bfloat16"``) stores the dense
        optimizer's slots in that dtype at rest
        (:func:`~models_tpu_torch.blocks.optimizer.low_precision_optimizer_state`;
        not with a :class:`MultiOptimizer`); the row-sparse slots stay
        float32.

        ``steps_per_execution`` (at least 1) runs that many steps a chunk in
        ``fit``, without an embedding optimizer (see the module's note). With
        ``jit`` (the default) a chunk on the card is one CUDA graph replay;
        ``jit=False`` runs the same chunk eagerly. Every captured graph dies
        with the next ``compile()``."""
        if train_metrics_steps < 1:
            raise ValueError(f"train_metrics_steps must be >= 1, got {train_metrics_steps}")
        check_optimizer(optimizer)
        if optimizer_state_dtype is not None and isinstance(optimizer, MultiOptimizer):
            raise ValueError("optimizer_state_dtype: wrap the individual optimizers of a "
                             "MultiOptimizer with low_precision_optimizer_state instead")
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
        self._optimizer_spec = optimizer
        self._optimizer_state_dtype = (None if optimizer_state_dtype is None
                                       else state_dtype(optimizer_state_dtype))
        self._learning_rate = learning_rate
        self._loss_spec = loss
        self._metrics_spec = metrics
        self._loss_weights = dict(loss_weights or {})
        self._class_weight = class_weight
        self._head_weights: Dict[str, tuple] = {}
        self.train_metrics_steps = train_metrics_steps
        self._steps_per_execution = max(int(steps_per_execution), 1)
        self._jit = bool(jit)
        # every compiled-artifact cache dies with compile(): a graph holds the
        # optimizer, losses and metrics resolved when it was captured
        self._chunk_graphs = ChunkGraphs()
        self._group_graphs: Dict[int, ChunkGraphs] = {}
        self._eval_graphs = ChunkGraphs(eval_tensors)
        self._optimizer = None
        self._plain_optimizer = True
        self._frozen_ids: frozenset = frozenset()
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
            t, sw = _unwrap_targets(pred)
            outputs = pred.outputs.detach()
            sw = _merge_row_valid(sw, row_valid, outputs.shape[0])
            if sw is not None and sw.ndim == 2 and sw.shape[1] > 1 and sw.shape == outputs.shape:
                sw = sw[:, 0]  # per-candidate weights: the positive's column
            if outputs.ndim == 3:  # sequence logits (B, L, C) -> (B * L, C)
                outputs = outputs.reshape(-1, outputs.shape[-1])
                if t is not None and t.ndim >= 2:
                    t = t.reshape(-1) if t.ndim == 2 else t.reshape(-1, t.shape[-1])
                if sw is not None:
                    sw = sw.reshape(-1)
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

    def _loss_weight_for(self, name: str) -> float:
        """A head's loss weight: ``compile(loss_weights=)`` by its name, then
        by its bare target; then a block's ``task_weight_dict`` likewise;
        else 1."""
        base = name.split("/")[0]
        for weights in [self._loss_weights] + [
                m.task_weight_dict for m in self.modules()
                if isinstance(getattr(m, "task_weight_dict", None), dict)]:
            if name in weights:
                return float(weights[name])
            if base in weights:
                return float(weights[base])
        return 1.0

    def _class_weight_for(self, name: str) -> Optional[Tuple[float, float]]:
        """(w0, w1) for a head's rows by label, from ``compile(class_weight=)``:
        a flat ``{0: w0, 1: w1}`` for the binary heads only, or a nested dict
        by head name or bare target; None where none applies."""
        cw = self._class_weight
        if not cw:
            return None
        if all(isinstance(k, (int, np.integer)) for k in cw):
            binary = {h.block_name for h in self.heads() if isinstance(h, BinaryOutput)}
            return (float(cw.get(0, 1.0)), float(cw.get(1, 1.0))) if name in binary else None
        task = cw.get(name) or cw.get(name.split("/")[0])
        return None if task is None else (float(task.get(0, 1.0)), float(task.get(1, 1.0)))

    def _weights_of(self, name: str) -> tuple:
        """(loss weight, class weights) of a head, resolved once a compile."""
        if name not in self._head_weights:
            self._head_weights[name] = (self._loss_weight_for(name),
                                        self._class_weight_for(name))
        return self._head_weights[name]

    def _compute_losses(self, pred_dict, x, loss_fns):
        """(total, logs): each head's loss under ``loss/<head>``, their
        weighted sum (the module's note) under ``loss``. A fused head's loss
        has its sample weights folded in; its loss weight multiplies it
        here. Class weights multiply the sample weights after the row
        validity."""
        row_valid = x.get(ROW_VALID_KEY)
        logs: Dict[str, torch.Tensor] = {}
        # the sum starts on the heads' device: a packed batch has no row
        # validity to take it from, and a chunk's graph copies nothing from
        # the host
        dev = next((p.outputs.device for p in pred_dict.values() if torch.is_tensor(p.outputs)),
                   None)
        total = torch.zeros((), device=dev)
        for name in sorted(pred_dict):
            pred = pred_dict[name]
            if pred.precomputed_loss is not None:
                value = pred.precomputed_loss
            elif pred.targets is None or name not in loss_fns:
                continue
            else:
                t, sw = _unwrap_targets(pred)
                sw = _merge_row_valid(sw, row_valid, pred.outputs.shape[0])
                cw = self._weights_of(name)[1]
                if cw is not None:
                    csw = torch.where(t > 0, cw[1], cw[0]).to(torch.float32)
                    if csw.ndim == 2 and csw.shape[-1] == 1:
                        csw = csw[:, 0]
                    sw = csw if sw is None else sw * csw.reshape(sw.shape)
                value = _auto_loss(loss_fns[name], t, pred.outputs, sw)
            logs[f"loss/{name}"] = value
            total = total + self._weights_of(name)[0] * value
        reg = torch.zeros_like(total)
        for m in self.modules():
            fn = getattr(m, "regularization_loss", None)
            term = fn() if fn is not None and m is not self else None
            if term is not None:
                reg = reg + term
        total = total + reg
        logs["regularization_loss"] = reg
        logs["loss"] = total
        return total, logs

    # ------------------------------------------------------------------
    # freezing
    # ------------------------------------------------------------------
    def freeze_blocks(self, blocks) -> None:
        """Freeze blocks (instances, or names matched against ``block_name``,
        one or a list): the next ``fit`` leaves their parameters, and their
        row-sparse tables, as they are, without a re-``compile``."""
        for b in self._match_blocks(blocks):
            b._frozen = True

    def unfreeze_blocks(self, blocks) -> None:
        for b in self._match_blocks(blocks):
            b._frozen = False

    def unfreeze_all_frozen_blocks(self) -> None:
        for b in self.frozen_blocks():
            b._frozen = False

    def frozen_blocks(self) -> List[nn.Module]:
        return [m for m in self.modules() if getattr(m, "_frozen", False)]

    def _match_blocks(self, spec) -> List[nn.Module]:
        out = []
        for s in spec if isinstance(spec, (list, tuple)) else [spec]:
            if isinstance(s, nn.Module):
                out.append(s)
                continue
            found = [m for m in self.modules() if getattr(m, "block_name", None) == s]
            if not found:
                raise ValueError(f"No block named {s!r}")
            out.extend(found)
        return out

    # ------------------------------------------------------------------
    # row-sparse embedding training
    # ------------------------------------------------------------------
    def _embedding_tables(self) -> List[EmbeddingTable]:
        """The trainable tables (a frozen table, ``trainable=False``, is a
        buffer that no optimizer sees)."""
        return [m for m in self.modules() if isinstance(m, EmbeddingTable) and m.trainable]

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
        """One row-sparse update per lookup: table by table, each table's in
        the sorted order of their keys (the column's name, or a tied head's
        ``"neg"`` and ``"pos"``), as the JAX package applies them: its
        lookups leave the traced step as a dict, which comes back sorted. A
        table that serves two columns, or a tied table looked up at two
        sites, takes two updates."""
        g = self._mesh.group(pmesh.DATA_AXIS) if self._mesh is not None else None
        for table in self._sparse_tables:
            if id(table.table) in self._frozen_ids:
                continue
            mine = sorted((entry for entry in lookups if entry[0] is table), key=lambda e: e[3])
            for _, ids, rows, _ in mine:
                grad = rows.grad if rows.grad is not None else torch.zeros_like(rows)
                if g is not None and g.size > 1:
                    # the global batch's (ids, row gradients), the gradients
                    # of the global mean loss, the same on every rank
                    ids = all_gather(ids.reshape(-1).to(torch.int32), g)
                    grad = all_gather(grad.reshape(-1, grad.shape[-1]).float(), g) / g.size
                self._emb_opt.apply(table, ids, grad, self._step)

    @staticmethod
    def _apply_pre(pre, x, y, training: bool):
        """The ``pre=`` transform on one batch on the device: ``(x, y)``, the
        targets from the transform's return or, where it returns the
        features alone, from its context."""
        context = ModelContext(features=x, targets=y)
        out = pre(x, targets=y, training=training, context=context)
        if isinstance(out, tuple):
            return out
        return out, context.targets if context.targets is not None else y

    def train_step(self, x: Dict[str, torch.Tensor], y, loss_fns,
                   mark: Optional[Callable[[str], None]] = None,
                   task_metrics=None, metric_states=None) -> Dict[str, torch.Tensor]:
        """One step on a batch already on the model's device: the ``pre=``
        transform of ``fit`` where one is set, forward, backward, dense
        optimizer step, row-sparse updates. Returns the step's logs,
        detached, on the device. With ``metric_states`` the step feeds the
        metrics: the heads return their logits (``need_logits``) and the
        states of ``task_metrics`` are updated in place. ``mark``, where
        given, is called with the name of each part as its work is queued
        (``loss_forward``, ``backward``, ``optimizer``, ``sparse_update``), so
        that a caller can time the parts."""
        mark = mark or (lambda name: None)
        with_metrics = metric_states is not None
        pre = getattr(self, "_pre_transform", None)
        if pre is not None:
            x, y = self._apply_pre(pre, x, y, training=True)
        context = ModelContext(features=x, targets=y, step=self._step, need_logits=with_metrics,
                               head_losses=loss_fns)
        mesh = self._mesh
        if mesh is not None:
            context["mesh"] = mesh
        if self._sparse_tables:
            context["sparse_lookups"] = []
        with data_scope(mesh.group(pmesh.DATA_AXIS) if mesh is not None else None):
            preds = self(x, targets=y, training=True, context=context)
            pred_dict = self._as_pred_dict(preds)
            total, logs = self._compute_losses(pred_dict, x, loss_fns)
            if with_metrics:
                self._update_metrics(metric_states, pred_dict, x, task_metrics)
            mark("loss_forward")
            # every gradient, a frozen parameter's too (it is in no optimizer)
            self.zero_grad(set_to_none=True)
            total.backward()
        if mesh is not None:
            self._reduce_grads(mesh)
        mark("backward")
        self._optimizer.step()
        mark("optimizer")
        if self._sparse_tables:
            self._apply_sparse(context["sparse_lookups"])
        mark("sparse_update")
        # the blocks' state (a cross-batch queue's ring), written in place
        # now that nothing of the step reads it
        apply_state_updates(context.get("state_updates"))
        self._step += 1
        return {k: v.detach() for k, v in logs.items()}

    # ------------------------------------------------------------------
    # meshes
    # ------------------------------------------------------------------
    def _sharded_ids(self) -> set:
        """The ids of the model's tensors held as slices of a mesh."""
        named = dict(self.named_parameters())
        named.update(dict(self.named_buffers()))
        return {id(named[n]) for n in pmesh.sharded_names(self) if n in named}

    @torch.no_grad()
    def _reduce_grads(self, mesh) -> None:
        """The dense parameters' gradients summed over the world and divided
        by its size, in one all-reduce a dtype: the global mean loss's (the
        ranks of a model line hold the same ones). A sharded parameter's
        gradient is the global batch's already (its lookup's backward)."""
        sharded = self._sharded_ids()
        grads = [p.grad for g in self._optimizer.param_groups for p in g["params"]
                 if p.grad is not None and id(p) not in sharded]
        all_reduce_tree(grads, mesh.world_group)
        for grad in grads:
            grad.div_(mesh.world)

    @staticmethod
    @torch.no_grad()
    def _data_mean(values: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
        """Each scalar's mean over the rank's data line, in one all-reduce."""
        g = mesh.group(pmesh.DATA_AXIS)
        if g.size == 1 or not values:
            return values
        stacked = torch.stack([v.float().reshape(()) for v in values.values()])
        all_reduce(stacked, g)
        return dict(zip(values, stacked / g.size))

    @torch.no_grad()
    def _check_replicas(self, mesh) -> None:
        """Raise unless every rank holds the same weights and integer state
        (the model whole, before it is placed; a dynamic table's keys among
        it): each tensor's sum and sum of squares (float64) against the
        chief's."""
        g = mesh.world_group
        stats = [v for t in pmesh.named_tensors(self).values() if t.dtype != torch.bool
                 for v in (t.double().sum(), t.double().square().sum())]
        if g.size == 1 or not stats:
            return
        every = all_gather(torch.stack(stats)[None], g)
        bad = [g.ranks[i] for i in range(g.size) if not torch.equal(every[i], every[0])]
        if bad:
            raise RuntimeError(f"ranks {bad} hold other weights than rank {g.ranks[0]}: build "
                               "every rank's model from the same seed (or load the same "
                               "parameters) before fit(mesh=)")

    def _place_on_mesh(self, mesh, shard_rules) -> None:
        """Shard the model's state on ``mesh`` (a model sharded on another
        mesh is made whole first), checking at the first placement that the
        ranks agree."""
        placed = pmesh.state_mesh(self)
        if placed is not None and placed is not mesh:
            pmesh.unshard_state(self)
        if pmesh.state_mesh(self) is None:
            self._check_replicas(mesh)
        pmesh.shard_state(self, mesh, shard_rules)

    @staticmethod
    def _mesh_batches(loader, mesh, dev, steps: Optional[int]):
        """This rank's slice of each of the loader's first ``steps`` batches
        (all where None), on the device, one batch ahead of the step that
        takes it (:func:`_device_prefetch`: the JAX package's
        ``_mesh_prefetch``)."""
        return _device_prefetch(((pmesh.shard_batch(x, mesh), pmesh.shard_batch(y, mesh))
                                 for x, y in islice(loader, steps)), dev)

    # ------------------------------------------------------------------
    # k steps a chunk (steps_per_execution)
    # ------------------------------------------------------------------
    @staticmethod
    def _column_leaves(feats: Dict[str, Any], targets) -> Tuple[list, str]:
        """The columns as (where, name, part, array) leaves, a list column as
        its values and its mask, and how the targets nest ("none", "one" or
        "dict")."""
        leaves = []
        for name, v in feats.items():
            if isinstance(v, SequenceFeature):
                leaves += [("x", name, "values", v.values), ("x", name, "mask", v.mask)]
            else:
                leaves.append(("x", name, None, v))
        if isinstance(targets, dict):
            return leaves + [("y", name, None, v) for name, v in targets.items()], "dict"
        if targets is None:
            return leaves, "none"
        return leaves + [("y", None, None, targets)], "one"

    @staticmethod
    def _pack_device_columns(feats: Dict[str, Any], targets, n_rows: int
                             ) -> Tuple[np.ndarray, tuple]:
        """Every feature and target column in ONE (n, F) int32 matrix (float32
        bit-cast, bool widened, a list column's values and mask each their
        own block of columns) and the static spec that :meth:`_make_unpack`
        decodes it by: a chunk then slices one tensor a batch, not one a
        column (the JAX package's ``_pack_device_columns``)."""
        leaves, y_kind = Model._column_leaves(feats, targets)
        entries, cols, off = [], [], 0
        for where, name, part, leaf in leaves:
            a = np.asarray(leaf)
            tail = a.shape[1:]
            w = int(np.prod(tail)) if tail else 1
            flat = np.ascontiguousarray(a.reshape(n_rows, w))
            if flat.dtype == np.bool_:
                kind, flat = "bool", flat.astype(np.int32)
            elif flat.dtype.kind == "f":
                kind, flat = "f32", flat.astype(np.float32).view(np.int32)
            else:
                kind, flat = "i32", flat.astype(np.int32)
            entries.append((where, name, part, kind, off, w, tail))
            cols.append(flat)
            off += w
        packed = np.concatenate(cols, axis=1) if cols else np.zeros((n_rows, 0), np.int32)
        return packed, (tuple(entries), y_kind)

    @staticmethod
    def _make_unpack(spec: tuple) -> Callable[[torch.Tensor], tuple]:
        """The inverse of :meth:`_pack_device_columns` for one (B, F) slice:
        ``(features, targets)``, each column a view of the slice (float
        columns bit-cast back, no copy), bool columns ``!= 0``."""
        entries, y_kind = spec

        def unpack(sl: torch.Tensor):
            x: Dict[str, Any] = {}
            y: Dict[str, Any] = {}
            parts: Dict[str, Dict[str, torch.Tensor]] = {}
            for where, name, part, kind, off, w, tail in entries:
                col = sl[:, off:off + w]
                if kind == "f32":
                    col = col.view(torch.float32)
                elif kind == "bool":
                    col = col != 0
                col = col.reshape((sl.shape[0],) + tuple(tail))
                if part is not None:
                    parts.setdefault(name, {})[part] = col
                elif where == "x":
                    x[name] = col
                else:
                    y[name] = col
            for name, p in parts.items():
                x[name] = SequenceFeature(p["values"], p["mask"])
            if y_kind == "none":
                return x, None
            return x, (y[None] if y_kind == "one" else y)

        return unpack

    @staticmethod
    def _device_train_pack(loader: Loader, dev: torch.device) -> Optional[DevicePack]:
        """The loader's dataset as one packed matrix on ``dev``, cached on the
        dataset (``_device_train_pack``; at most two datasets keep one, the
        least recently packed dropped first), or None where the route does
        not apply: batches that keep a partial last one, or a pack of more
        than 2 GiB. The pack does not depend on the batch size."""
        if not loader.drop_last:
            return None
        ds = loader.dataset
        cached = getattr(ds, "_device_train_pack", None)
        if cached is not None and cached.packed.device == dev:
            return cached
        try:  # refuses a dataset with no rows, among others
            feats, targets, n_rows = loader.dense_columns()
        except ValueError:
            return None
        leaves, _ = Model._column_leaves(feats, targets)
        if sum(np.asarray(leaf[-1]).nbytes for leaf in leaves) > MAX_PACK_BYTES:
            return None
        packed, spec = Model._pack_device_columns(feats, targets, n_rows)
        pack = DevicePack(n_rows, spec, _upload(packed, dev))
        ds._device_train_pack = pack
        _keep_pack(ds)
        return pack

    @staticmethod
    def _device_bucket_groups(loader: Loader, dev: torch.device
                              ) -> Optional[List[Tuple[int, DevicePack]]]:
        """The loader's dataset grouped by length bucket
        (``Loader.bucketed_dense_columns``), each group one packed matrix on
        ``dev``: ``[(bucket, DevicePack), ...]``, cached on the dataset
        (``_device_bucket_groups``) beside the unbucketed pack. None where the
        route does not apply, as the JAX package rules: batches that keep a
        partial last one, groups whose full batches hold less than 80% of
        the rows (drop_last applies to each group), or more than 2 GiB
        packed."""
        if not loader.drop_last:
            return None
        ds = loader.dataset
        groups = getattr(ds, "_device_bucket_groups", None)
        if groups is None or groups[0][1].packed.device != dev:
            try:
                raw = loader.bucketed_dense_columns()
            except ValueError:
                return None
            leaves = [leaf for _, f, t, _ in raw for leaf in Model._column_leaves(f, t)[0]]
            if sum(np.asarray(leaf[-1]).nbytes for leaf in leaves) > MAX_PACK_BYTES:
                return None
            groups = []
            for bucket, feats, targets, n in raw:
                packed, spec = Model._pack_device_columns(feats, targets, n)
                groups.append((bucket, DevicePack(n, spec, _upload(packed, dev))))
            ds._device_bucket_groups = groups
            _keep_pack(ds)
        B = loader.batch_size
        total = sum(g.n_rows for _, g in groups)
        if sum(g.n_rows // B * B for _, g in groups) < 0.8 * total:
            return None
        return groups

    @staticmethod
    def _pack_for_eval(loader: Loader, dev: torch.device) -> Optional[DevicePack]:
        """The eval loader's dataset as one packed matrix on ``dev`` (the
        training pack's layout), padded with zero rows to whole batches: the
        rows the loader pads its last batch with, which the evaluation chunk
        masks by ``__row_valid__``; ``n_rows`` is the real row count. Cached
        on the dataset (``_device_eval_pack``, by batch size and device; at
        most two datasets keep one, the least recently packed dropped
        first). None where the JAX package's ``_pack_for_eval`` refuses: a
        process's share of the rows (``global_size``), a per-batch
        ``transform``, ``pad="bucket"``, a loader that drops its last partial
        batch (streaming would drop its rows), no rows, or columns of more
        than 1 GiB."""
        if (loader.global_size != 1 or loader.transform is not None
                or getattr(loader, "pad", "max") != "max" or loader.drop_last):
            return None
        B = loader.batch_size
        ds = loader.dataset
        cached = getattr(ds, "_device_eval_pack", None)
        if cached is not None and cached[0] == B and cached[1].packed.device == dev:
            return cached[1]
        try:  # refuses a dataset with no rows, among others
            feats, targets, n_rows = loader.dense_columns()
        except ValueError:
            return None
        leaves, _ = Model._column_leaves(feats, targets)
        if sum(np.asarray(leaf[-1]).nbytes for leaf in leaves) > MAX_EVAL_PACK_BYTES:
            return None
        packed, spec = Model._pack_device_columns(feats, targets, n_rows)
        packed = np.pad(packed, ((0, -n_rows % B), (0, 0)))
        pack = DevicePack(n_rows, spec, _upload(packed, dev))
        ds._device_eval_pack = (B, pack)
        _keep_eval_pack(ds)
        return pack

    def _eval_step(self, x, y, loss_fns, task_metrics, states, acc: Dict[str, torch.Tensor],
                   mesh=None) -> Dict[str, torch.Tensor]:
        """One evaluation step on a batch on the device, the same on every
        route: the heads' evaluation branch (``testing``, with logits), the
        metric ``states`` updated in place. Returns ``acc`` with the batch's
        loss added to ``"total"`` and 1 to ``"count"``."""
        context = ModelContext(features=x, targets=y, testing=True, need_logits=True)
        if mesh is not None:
            context["mesh"] = mesh
        with data_scope(mesh.group(pmesh.DATA_AXIS) if mesh is not None else None):
            preds = self(x, targets=y, training=False, context=context)
            pred_dict = self._as_pred_dict(preds)
            total, _ = self._compute_losses(pred_dict, x, loss_fns)
        self._update_metrics(states, pred_dict, x, task_metrics)
        return {"total": acc["total"] + total, "count": acc["count"] + 1.0}

    def _eval_chunk_fn(self, k: int, batch_size: int, n_rows: int, spec: tuple, loss_fns,
                       task_metrics) -> Callable:
        """``fn(source, idx, states) -> (logs, states)``: the eval pack's rows
        at ``idx`` (k whole batches) gathered (K9, one launch), then k
        evaluation steps (:meth:`_eval_step`) on contiguous (batch_size, F)
        slices of them, each slice's ``__row_valid__`` its rows below
        ``n_rows``. ``states`` is ``(metric states, {"total", "count"})``,
        all on the device; no logs. The model's step count does not move
        (the JAX package's ``_device_eval_scan``)."""
        unpack = self._make_unpack(spec)

        def fn(source: torch.Tensor, idx: torch.Tensor, states):
            metric_states, acc = states
            with torch.no_grad():
                rows = row_gather(source, idx)
                for i in range(k):
                    x, y = unpack(rows[i * batch_size:(i + 1) * batch_size])
                    x[ROW_VALID_KEY] = idx[i * batch_size:(i + 1) * batch_size] < n_rows
                    acc = self._eval_step(x, y, loss_fns, task_metrics, metric_states, acc)
            return {}, (metric_states, acc)

        return fn

    def _try_device_eval(self, loader: Loader, loss_fns, task_metrics,
                         dev: torch.device) -> Optional[Callable]:
        """The device-resident evaluation of the loader's dataset (the JAX
        package's ``_try_device_eval``): ``run() -> (metric states, {"total",
        "count"})`` over its eval pack (:meth:`_pack_for_eval`), or None
        where it has none. ``run`` takes the pack in chunks of at most
        EVAL_CHUNK_BATCHES batches (:meth:`_eval_chunk_fn`), each one CUDA
        graph replay on the card (``_eval_graphs``, keyed by the chunk's
        batches, the batch size, the row count, the pack's layout with its
        column names, and the dtype policy; the first call of a key eager,
        the second captured), eagerly on the CPU. The batches are the
        streaming route's, padding included, and each step is its step: the
        two routes agree bit for bit."""
        pack = self._pack_for_eval(loader, dev)
        if pack is None:
            return None
        B = loader.batch_size
        n_batches = pack.packed.shape[0] // B

        def run():
            states = (self._init_metric_states(task_metrics, dev),
                      {"total": torch.zeros((), device=dev), "count": torch.zeros((), device=dev)})
            for start in range(0, n_batches, EVAL_CHUNK_BATCHES):
                with trace.span("evaluate.chunk"):
                    k = min(EVAL_CHUNK_BATCHES, n_batches - start)
                    idx = torch.arange(start * B, (start + k) * B, dtype=torch.int32, device=dev)
                    fn = self._eval_chunk_fn(k, B, pack.n_rows, pack.spec, loss_fns,
                                             task_metrics)
                    if dev.type == "cuda":
                        key = (k, B, pack.n_rows, pack.spec, get_dtype_policy())
                        _, states = self._eval_graphs.run(self, key, fn, pack.packed, idx,
                                                          states, 0)
                    else:
                        _, states = fn(pack.packed, idx, states)
            return states

        return run

    def _chunk_fn(self, k: int, batch_size: int, spec: tuple, loss_fns, task_metrics,
                  with_metrics: bool) -> Callable:
        """``fn(source, idx, states) -> (logs, states)``: the chunk's rows of
        ``source`` gathered at ``idx`` (K9, one launch), then k train steps
        on contiguous (batch_size, F) slices of them; the logs of each name
        stacked (k,). With ``with_metrics`` every step of the chunk feeds
        the metrics, as the JAX package's chunk does where one of its steps
        is a metric step."""
        unpack = self._make_unpack(spec)

        def fn(source: torch.Tensor, idx: torch.Tensor, states):
            rows = row_gather(source, idx)
            step_logs: Dict[str, List[torch.Tensor]] = {}
            for i in range(k):
                x, y = unpack(rows[i * batch_size:(i + 1) * batch_size])
                logs = self.train_step(x, y, loss_fns, task_metrics=task_metrics,
                                       metric_states=states if with_metrics else None)
                for name, v in logs.items():
                    step_logs.setdefault(name, []).append(v)
            return {name: torch.stack(v) for name, v in step_logs.items()}, states

        return fn

    def _run_chunk(self, source: torch.Tensor, spec: tuple, idx: torch.Tensor, k: int,
                   batch_size: int, with_metrics: bool, loss_fns, task_metrics, states,
                   graphs: Optional[ChunkGraphs] = None):
        """One chunk of k steps: a CUDA graph replay on the card under
        ``jit`` (``graphs``, a
        :class:`~models_tpu_torch.models.step_graph.ChunkGraphs`: the
        model's, or a bucket group's), else eagerly."""
        fn = self._chunk_fn(k, batch_size, spec, loss_fns, task_metrics, with_metrics)
        if not (self._jit and source.device.type == "cuda"):
            return fn(source, idx, states)
        # the source's address is not in the key: ChunkGraphs drops every
        # graph when a tensor it captured (the source among them) is replaced
        key = (k, with_metrics, batch_size, spec, get_dtype_policy())
        graphs = self._chunk_graphs if graphs is None else graphs
        return graphs.run(self, key, fn, source, idx, states, k)

    def _host_chunk(self, batches, dev):
        """k host batches packed into one (k B, F) matrix on ``dev`` (their
        ``__row_valid__`` with them) and its spec: a chunk of the host route.
        The matrix is copied into one staging tensor of its shape, kept on the
        model, so that a captured chunk finds it at the same address."""
        xs = [x for x, _ in batches]
        ys = [y for _, y in batches]

        def stack(vals):
            v0 = vals[0]
            if isinstance(v0, SequenceFeature):
                return SequenceFeature(np.concatenate([v.values for v in vals]),
                                       np.concatenate([v.mask for v in vals]))
            return np.concatenate(vals)

        feats = {name: stack([x[name] for x in xs]) for name in xs[0]}
        if ys[0] is None:
            targets = None
        elif isinstance(ys[0], dict):
            targets = {name: stack([y[name] for y in ys]) for name in ys[0]}
        else:
            targets = stack(ys)
        n = sum(len(x[ROW_VALID_KEY]) for x in xs)
        packed, spec = self._pack_device_columns(feats, targets, n)
        stage = getattr(self, "_host_stage", None)
        if stage is None or stage.shape != packed.shape or stage.device != dev:
            stage = self._host_stage = torch.empty(packed.shape, dtype=torch.int32, device=dev)
        stage.copy_(torch.from_numpy(packed))
        return stage, spec

    def _build_optimizer(self) -> None:
        """Route the tables and make the dense optimizer (a
        :class:`MultiOptimizer`'s, where compiled with one) over the
        parameters that train densely and are not frozen."""
        frozen = self.frozen_blocks()
        self._frozen_ids = frozenset(id(p) for b in frozen for p in b.parameters())
        multi = isinstance(self._optimizer_spec, MultiOptimizer)
        self._plain_optimizer = not frozen and not multi
        self._sparse_tables = self._setup_sparse_embeddings()
        skip = {id(t.table) for t in self._sparse_tables} | self._frozen_ids
        named = [(n, p) for n, p in self.named_parameters()
                 if p.requires_grad and id(p) not in skip]
        if multi:
            self._optimizer = self._optimizer_spec.build(named, self._learning_rate)
        else:
            self._optimizer = make_optimizer(self._optimizer_spec, [p for _, p in named],
                                             self._learning_rate)
        if self._optimizer_state_dtype is not None:
            self._optimizer = low_precision_optimizer_state(self._optimizer,
                                                            self._optimizer_state_dtype)

    @trace.traced("fit")
    def fit(self, data: Union[Dataset, Loader], epochs: int = 1,
            batch_size: Optional[int] = None, shuffle: bool = True,
            validation_data: Union[None, Dataset, Loader] = None,
            steps_per_epoch: Optional[int] = None, callbacks: Optional[list] = None,
            pre: Optional[nn.Module] = None, verbose: int = 1, mesh=None, shard_rules=None,
            validation_freq: int = 1, initial_epoch: int = 0,
            validation_steps: Optional[int] = None, device=None) -> History:
        """Train for ``epochs`` passes over ``data`` in full batches (the
        loader drops the last partial one). ``history[name]`` holds each
        epoch's mean step log, the metrics over its metric steps, plus
        ``examples_per_sec`` (host clock); with ``validation_data``, every
        ``validation_freq``-th epoch adds :meth:`evaluate`'s results under
        ``val_<name>`` (on its device route where it takes one; on the
        training pack's route with no callbacks, every epoch validated over
        every batch and no step but a chunk's first differing, the
        validation follows the epoch's last chunk and one copy to the host
        brings both logs, ``examples_per_sec`` then timing both). With
        ``compile(steps_per_execution=k)``, k steps a chunk (the module's
        note); the batches and their order are the streaming route's.
        Streamed one step at a time without ``pre``, each batch is copied to
        the device one batch ahead of its step.

        ``pre``: a transform of each batch on the device before its step
        (``SequencePredictNext``, ``SequenceMaskRandom``, ...), run inside
        the step, so inside a chunk's captured graph; it must take the
        batch's tensors and return ``(features, targets)`` (or the
        features, its context's ``targets`` set) with no copy to the host.
        It is moved to the model's device. A loader with ``pad="bucket"``
        and k steps a chunk trains each length bucket's rows as a group of
        its own (``_device_bucket_groups``), one packed matrix and one set of
        graphs a group, the groups in bucket order, each shuffled by its own
        permutation; where that route does not apply, one step at a time.

        ``steps_per_epoch`` bounds an epoch's batches on every route (the
        bucket groups' together, in their order). ``callbacks``
        (:mod:`~models_tpu_torch.utils.callbacks`, or any object with some of
        the hooks): ``set_model(model)`` first, then ``on_epoch_begin(epoch)``,
        ``on_batch_end(step, logs)`` after each step with its logs (device
        tensors; with k steps a chunk, after each chunk with its last step's
        logs and the index of that step), ``on_epoch_end(epoch, logs)`` with
        the epoch's logs, and ``on_train_end(history)``. A callback that sets
        ``model.stop_training`` ends the fit after that epoch. ``verbose``
        prints each epoch's logs (the JAX package's line). The model is built
        first (:meth:`build`); a loader that yields no full batch raises the
        JAX package's ``ValueError``.

        ``initial_epoch``: the epoch to start from (the epochs run are
        ``initial_epoch`` ... ``epochs - 1``, as Keras counts them), to
        continue a run: the optimizer's slots and the step count carry over
        from the last ``fit`` or from :meth:`arm_training_state`
        (``CheckpointManager.restore_training``). ``validation_steps`` bounds
        each validation's batches.

        ``mesh`` (:func:`~models_tpu_torch.parallel.make_mesh`, called by
        every rank) trains on it (the module's note): the model is placed by
        ``shard_rules`` (default ``parallel.mesh.DEFAULT_RULES``) and stays
        placed for ``evaluate``, ``predict`` and the next fit; the batch size
        is the global batch's and divides the data axis. Only the chief
        prints (``verbose``)."""
        with trace.span("fit.prepare"):
            if not self._compiled:
                self.compile()
            if not 0 <= initial_epoch < max(epochs, 1):
                raise ValueError(f"initial_epoch={initial_epoch} must be in [0, epochs={epochs})")
            dev = check_module_device(self, device)
            if pre is not getattr(self, "_pre_transform", None):
                # a captured chunk holds the transform it ran
                self._chunk_graphs.clear()
                self._group_graphs.clear()
            self._pre_transform = pre.to(dev) if isinstance(pre, nn.Module) else pre
            loader = data if isinstance(data, Loader) else Loader(
                data, batch_size or 1024, drop_last=True, shuffle=shuffle)
            if len(loader) == 0:
                loader.peek()  # raises: the loader yields no batch
            self.build(loader, device=dev)
            B = loader.batch_size
            if mesh is not None:
                if mesh.device != dev:
                    raise ValueError(f"the mesh's rank lives on {mesh.device}, the model on {dev}")
                if B % mesh.size(pmesh.DATA_AXIS):
                    raise ValueError(f"batch {B} does not divide the mesh's data axis "
                                     f"{mesh.size(pmesh.DATA_AXIS)}")
                self._place_on_mesh(mesh, shard_rules)
            elif pmesh.state_mesh(self) is not None:
                pmesh.unshard_state(self)  # a fit with no mesh trains the whole model
            self._mesh = mesh
            loss_fns = self._resolve_task_losses()
            task_metrics = self._resolve_task_metrics()
            has_metrics = any(task_metrics.values())
            fingerprint = None if mesh is None else mesh.fingerprint
            fresh = (self.frozen_blocks() or isinstance(self._optimizer_spec, MultiOptimizer)
                     or not self._plain_optimizer
                     or getattr(self, "_fit_mesh_fp", None) != fingerprint)
            if self._optimizer is None or fresh:
                # the JAX package rebuilds its transform for frozen blocks or a
                # MultiOptimizer, and then starts from fresh slots at step 0
                if self._optimizer is not None:
                    self._step = 0
                self._chunk_graphs.clear()
                self._group_graphs.clear()
                self._build_optimizer()
            self._fit_mesh_fp = fingerprint
            self.stop_training = False
            callbacks = list(callbacks or [])
            for cb in callbacks:
                getattr(cb, "set_model", lambda m: None)(self)

            def hook(name, *args):
                for cb in callbacks:
                    getattr(cb, name, lambda *a: None)(*args)

            # k steps a chunk only without an embedding optimizer and off a mesh:
            # the JAX package sets spe = 1 there
            spe = 1 if self._sparse_tables or mesh is not None else self._steps_per_execution
            bucketed = getattr(loader, "pad", "max") == "bucket"
            groups = self._device_bucket_groups(loader, dev) if spe > 1 and bucketed else None
            if bucketed and groups is None:
                spe = 1  # bucketed batches differ in shape: no chunk of host batches
            pack = self._device_train_pack(loader, dev) if spe > 1 and not bucketed else None

            def epoch_perms(n_rows: int, salt: int = 0) -> torch.Tensor:
                # every epoch's permutation in one upload, drawn from the loader's
                # epoch seeds (a bucket group's salted with its bucket, as the JAX
                # package salts them): the device route trains on the streaming
                # route's batches, in its order
                drawn = np.stack([
                    np.random.default_rng(loader.seed + (loader._epoch + 1 + e) * 9973 + salt
                                          ).permutation(n_rows) if loader.shuffle
                    else np.arange(n_rows)
                    for e in range(epochs - initial_epoch)]).astype(np.int32)
                trace.count("h2d.bytes", drawn.nbytes)
                return torch.as_tensor(drawn, device=dev)

            if pack is not None:
                perms = epoch_perms(pack.n_rows)
            if groups is not None:
                group_perms = {bucket: epoch_perms(g.n_rows, bucket & 0xFFFF)
                               for bucket, g in groups}

            def metric_chunk(k):
                return has_metrics and any(
                    (self._step + i) % self.train_metrics_steps == 0 for i in range(k))

            # The JAX package also fuses every epoch into one program where no
            # step but the first of a chunk differs (train_metrics_steps == 1 or no
            # metrics), with no callbacks, the validation of every epoch over every
            # batch (validation_freq == 1, no validation_steps) scanned on the
            # device right after its training steps. Here that program is the
            # chunk itself: its graph is replayed once per chunk of each epoch and
            # computes what the fused epochs compute, and under those conditions
            # the device route's validation chunks follow the epoch's last chunk,
            # with one fetch an epoch for the training and the val_ logs.
            val_run = None
            if (validation_data is not None and pack is not None and not callbacks
                    and validation_freq == 1 and validation_steps is None
                    and (self.train_metrics_steps == 1 or not has_metrics)):
                val_run = self._eval_route(self._eval_loader(validation_data, batch_size or B),
                                           loss_fns, task_metrics, dev)
        history = History()
        for epoch in range(initial_epoch, epochs):
            hook("on_epoch_begin", epoch)
            t0 = time.perf_counter()
            states = self._init_metric_states(task_metrics, dev)
            step_logs: Dict[str, List[torch.Tensor]] = {}
            n_examples = 0

            def keep(logs):
                for name, v in logs.items():
                    step_logs.setdefault(name, []).append(v.reshape(-1))

            def single(step, xb, yb):
                nonlocal n_examples
                metric_step = has_metrics and self._step % self.train_metrics_steps == 0
                logs = self.train_step(xb, yb, loss_fns, task_metrics=task_metrics,
                                       metric_states=states if metric_step else None)
                keep(logs)
                n_examples += B
                hook("on_batch_end", step, logs)

            def chunk_done(step, logs):
                keep(logs)
                hook("on_batch_end", step, {name: v[-1] for name, v in logs.items()})

            if pack is not None or groups is not None:
                loader._epoch += 1  # the loader's seed bookkeeping, as if it had streamed
                budget = steps_per_epoch
                for bucket, gpack in groups or [(None, pack)]:
                    gperm = (perms if bucket is None else group_perms[bucket])[
                        epoch - initial_epoch]
                    graphs = (None if bucket is None
                              else self._group_graphs.setdefault(bucket, ChunkGraphs()))
                    n_batches, local = gpack.n_rows // B, 0
                    if budget is not None:
                        n_batches = min(n_batches, budget)
                        budget -= n_batches
                    while local < n_batches:
                        k = min(spe, n_batches - local)
                        with trace.span("fit.chunk"):
                            logs, states = self._run_chunk(
                                gpack.packed, gpack.spec, gperm[local * B:(local + k) * B],
                                k, B, metric_chunk(k), loss_fns, task_metrics, states, graphs)
                        n_examples += k * B
                        local += k
                        chunk_done(local - 1, logs)
            elif mesh is not None:
                for step, (xb, yb) in enumerate(
                        self._mesh_batches(loader, mesh, dev, steps_per_epoch)):
                    single(step, xb, yb)
            elif spe == 1 and self._pre_transform is None:
                # each batch copied one batch ahead of its step, as the JAX
                # package's streaming fit (in line with a transform)
                for step, (xb, yb) in enumerate(
                        _device_prefetch(islice(loader, steps_per_epoch), dev)):
                    single(step, xb, yb)
            else:
                chunk, taken = [], 0
                for step, (x, y) in enumerate(loader):
                    if steps_per_epoch is not None and step >= steps_per_epoch:
                        break
                    taken += 1
                    if spe == 1:
                        single(step, to_device_batch(x, dev), to_device_targets(y, dev))
                        continue
                    chunk.append((x, y))
                    if len(chunk) == spe:
                        source, spec = self._host_chunk(chunk, dev)
                        idx = torch.arange(spe * B, dtype=torch.int32, device=dev)
                        logs, states = self._run_chunk(source, spec, idx, spe, B,
                                                       metric_chunk(spe), loss_fns,
                                                       task_metrics, states)
                        n_examples += spe * B
                        chunk_done(step, logs)
                        chunk = []
                for i, (x, y) in enumerate(chunk):  # the batches that fill no chunk
                    single(taken - len(chunk) + i, to_device_batch(x, dev),
                           to_device_targets(y, dev))
            with trace.span("fit.finish"):
                values = {k: torch.cat(v).mean() for k, v in step_logs.items()}
                if mesh is not None:  # the global batch's logs and metrics
                    values = self._data_mean(values, mesh)
                    all_reduce_tree(states, mesh.group(pmesh.DATA_AXIS))
                values.update(self._metric_results(states, task_metrics))
                if val_run is not None:
                    # the validation follows the epoch's device work: the training
                    # and val_ logs in one copy, in the keys' order of the two;
                    # examples_per_sec then times both, as the JAX package's fused
                    # epochs (their one program's wall) do
                    with trace.span("fit.validate"):
                        val = self._eval_values(*val_run(), task_metrics)
                    both = _fetch({**values, **{f"val_{k}": v for k, v in val.items()}})
                    epoch_logs = {k: both[k] for k in sorted(values)}
                    epoch_logs["examples_per_sec"] = n_examples / max(
                        time.perf_counter() - t0, 1e-9)
                    epoch_logs.update((k, both[k]) for k in ["val_loss"] + sorted(
                        f"val_{k}" for k in val if k != "loss"))
                else:
                    epoch_logs = _fetch(values)  # one copy to the host per epoch
                    epoch_logs["examples_per_sec"] = n_examples / max(time.perf_counter() - t0,
                                                                      1e-9)
                if val_run is None and validation_data is not None \
                        and (epoch + 1) % validation_freq == 0:
                    with trace.span("fit.validate"):
                        val = self.evaluate(validation_data, batch_size=batch_size or B,
                                            steps=validation_steps, device=dev)
                    epoch_logs.update({f"val_{k}": v for k, v in val.items()})
                history.append(epoch_logs)
                if verbose and pmesh.is_chief():
                    msg = " - ".join(f"{k}: {v:.4f}" for k, v in epoch_logs.items())
                    print(f"Epoch {epoch + 1}/{epochs} - {msg}")
                hook("on_epoch_end", epoch, epoch_logs)
            if self.stop_training:
                break
        hook("on_train_end", history.history)
        self.history = history
        return history

    def _eval_route(self, loader: Loader, loss_fns, task_metrics, dev: torch.device,
                    pre=None, steps: Optional[int] = None) -> Optional[Callable]:
        """The device route's ``run`` (:meth:`_try_device_eval`) where the
        JAX package's ``evaluate`` takes it: no ``pre``, no mesh, ``jit``,
        every batch (no ``steps``) and an eval pack (which the loader's own
        conditions refuse: :meth:`_pack_for_eval`); else None, and the
        evaluation streams."""
        if pre is None and self._mesh is None and self._jit and steps is None:
            return self._try_device_eval(loader, loss_fns, task_metrics, dev)
        return None

    @staticmethod
    def _eval_loader(data: Union[Dataset, Loader], batch_size: Optional[int]) -> Loader:
        return data if isinstance(data, Loader) else Loader(data, batch_size or 1024)

    @trace.traced("evaluate")
    @torch.no_grad()
    def evaluate(self, data: Union[Dataset, Loader], batch_size: Optional[int] = None,
                 return_dict: bool = True, pre: Optional[nn.Module] = None, verbose: int = 0,
                 steps: Optional[int] = None, device=None) -> Dict[str, float]:
        """The loss and the metrics over ``data`` (every row, the last batch
        padded and its padding masked; at most ``steps`` batches): the heads
        take their evaluation branch (``testing``), the contrastive head
        scoring each batch's in-batch negatives, the top-k head the catalog.
        ``loss`` is the mean of the batches' losses. One copy to the host.

        Under ``compile(jit=True)`` (the default) the data goes
        device-resident where the JAX package's does (:meth:`_eval_route`):
        its columns are uploaded once as the eval pack (cached on the
        dataset) and evaluated in chunks of batches, each one CUDA graph
        replay on the card from the third call of a shape on (the first
        eager, the second captured), eagerly on the CPU; the same batches
        and steps as streaming, so the same results bit for bit. Elsewhere
        it streams, each batch copied to the device one batch ahead of its
        step (``_device_prefetch``). After ``fit(mesh=)`` it runs on that
        mesh, each rank on its data slice of every batch, the results the
        global batches'. ``pre``: a transform of each batch on the device,
        as ``fit``'s (``SequencePredictLast``: the next-item protocol).
        ``return_dict`` is taken and, as in the JAX package, the result is
        a dict either way; ``verbose`` prints it."""
        with trace.span("evaluate.prepare"):
            if not self._compiled:
                self.compile()
            dev = check_module_device(self, device)
            loader = self._eval_loader(data, batch_size)
            self.build(loader, device=dev)
            mesh = self._mesh
            if mesh is not None and loader.batch_size % mesh.size(pmesh.DATA_AXIS):
                raise ValueError(f"batch {loader.batch_size} does not divide the mesh's data "
                                 f"axis {mesh.size(pmesh.DATA_AXIS)}")
            loss_fns = self._resolve_task_losses()
            task_metrics = self._resolve_task_metrics()
            run = self._eval_route(loader, loss_fns, task_metrics, dev, pre, steps)
        if run is not None:
            states, acc = run()
        else:
            states = self._init_metric_states(task_metrics, dev)
            acc = {"total": torch.zeros((), device=dev), "count": torch.zeros((), device=dev)}
            if mesh is not None:
                batches = self._mesh_batches(loader, mesh, dev, steps)
            elif pre is None:
                batches = _device_prefetch(islice(loader, steps), dev)
            else:  # in line, as the JAX package's with a transform
                batches = ((to_device_batch(x, dev), to_device_targets(y, dev))
                           for x, y in islice(loader, steps))
            for xb, yb in batches:
                if pre is not None:
                    xb, yb = self._apply_pre(pre.to(dev), xb, yb, training=False)
                acc = self._eval_step(xb, yb, loss_fns, task_metrics, states, acc, mesh)
        with trace.span("evaluate.finish"):
            values = self._eval_values(states, acc, task_metrics, mesh)
            results = _fetch(values)
            results = {"loss": results.pop("loss"), **results}
            if verbose and pmesh.is_chief():
                print(" - ".join(f"{k}: {v:.4f}" for k, v in results.items()))
        return results

    def _eval_values(self, states, acc: Dict[str, torch.Tensor], task_metrics,
                     mesh=None) -> Dict[str, torch.Tensor]:
        """An evaluation's loss (the mean of its batches') and metrics, on
        the device; on a mesh the global batches' (reduced over the data
        line)."""
        values = {"loss": acc["total"] / acc["count"].clamp_min(1.0)}
        if mesh is not None:
            values = self._data_mean(values, mesh)
            all_reduce_tree(states, mesh.group(pmesh.DATA_AXIS))
        values.update(self._metric_results(states, task_metrics))
        return values

    @torch.no_grad()
    def batch_predict(self, data: Union[Dataset, Loader], batch_size: int = 1024,
                      prefix: str = "prediction", pre: Optional[nn.Module] = None,
                      device=None) -> Dataset:
        """:meth:`predict` over every row of ``data``, the dataset returned
        with the predictions appended as columns: ``prefix``, or
        ``<prefix>/<name>`` for each of a dict's outputs (a (n, k) output a
        2-D column)."""
        dataset = data.dataset if isinstance(data, Loader) else data
        preds = self.predict(data, batch_size=batch_size, pre=pre, device=device)
        cols = ({f"{prefix}/{k}": v for k, v in preds.items()} if isinstance(preds, dict)
                else {prefix: preds})
        return dataset.with_columns(cols)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def summary(self, print_fn=print) -> str:
        """The block tree with each block's own parameter count (its
        parameters and its blocks'), and the model's total, each parameter
        counted once (a tied table once), as the JAX package counts its
        ``nnx.Param`` leaves."""
        lines = [f"Model: {type(self).__name__} ({self.block_name or 'model'})"]
        seen = set()

        def walk(block, depth):
            if id(block) in seen:
                return
            seen.add(id(block))
            own = sum(p.numel() for p in block.parameters())
            name = getattr(block, "block_name", None) or type(block).__name__
            lines.append(f"{'  ' * depth}{name} [{type(block).__name__}]  params={own:,}")
            for child in block.children():
                if isinstance(child, Block):
                    walk(child, depth + 1)
                elif isinstance(child, (nn.ModuleList, nn.ModuleDict)):
                    for c in child.children():
                        if isinstance(c, Block):
                            walk(c, depth + 1)

        for child in self.children():
            for b in (child.children() if isinstance(child, (nn.ModuleList, nn.ModuleDict))
                      else [child]):
                if isinstance(b, Block):
                    walk(b, 1)
        total = sum(p.numel() for p in self.parameters())
        lines.append(f"Total params: {total:,} ({total * 4 / 2**20:.1f} MB fp32)")
        out = "\n".join(lines)
        if print_fn:
            print_fn(out)
        return out

    def save(self, path: str, format: str = "auto") -> str:
        """:func:`~models_tpu_torch.utils.io.save_model`."""
        from ..utils.io import save_model

        return save_model(self, path, format=format)

    @classmethod
    def load(cls, path: str, device=None) -> "BaseModel":
        """:func:`~models_tpu_torch.utils.io.load_model` on ``device``
        (default the card)."""
        from ..utils.io import load_model

        return load_model(path, device=device)

    def export_serving(self, path: str, data, batch_size: int = 1024, platforms=None,
                       device=None) -> str:
        """:func:`~models_tpu_torch.utils.io.export_serving`: the inference
        step as ``torch.export`` programs with no model code."""
        from ..utils.io import export_serving

        return export_serving(self, path, data=data, batch_size=batch_size,
                              platforms=platforms, device=device)

    def _inner_optimizer(self):
        """The dense optimizer whose ``state`` holds the slots (the wrapped
        one of a bf16 optimizer state), or None before the first fit."""
        opt = getattr(self, "_optimizer", None)
        return getattr(opt, "optimizer", opt)

    def training_state(self) -> Optional[dict]:
        """``{"opt_state", "global_step"}``: the dense optimizer's state
        (``state_dict()["state"]``: its slots and step counts by parameter
        index, references to the live tensors) and the step count, or None
        before the first fit. With the model's own state (parameters,
        row-sparse slots and buffers) it is what ``ModelCheckpoint`` saves
        so that a run resumes exactly (``CheckpointManager.restore_training``)."""
        inner = self._inner_optimizer()
        if inner is None:
            return None
        state = inner.state_dict()["state"]
        if pmesh.state_mesh(self) is not None:
            state = self._mesh_opt_state(inner, state, gather=True)
        return {"opt_state": state, "global_step": int(self._step)}

    def _mesh_opt_state(self, inner, state: dict, gather: bool) -> dict:
        """The optimizer state of a model on a mesh made whole (``gather``: a
        collective, the slots of each sharded parameter gathered) or cut to
        this rank's slices (a whole state, as a checkpoint holds it)."""
        if not all(isinstance(k, int) for k in state):
            raise NotImplementedError("the training state of a MultiOptimizer on a mesh is not "
                                      "ported yet")
        mesh = pmesh.state_mesh(self)
        named = {id(t): n for n, t in pmesh.named_tensors(self).items()}
        specs = pmesh.sharded_names(self)
        params = [p for g in inner.param_groups for p in g["params"]]
        out = {}
        for i, slots in state.items():
            spec = specs.get(named.get(id(params[i])))
            out[i] = dict(slots)
            if spec is None:
                continue
            for name, v in slots.items():
                if not torch.is_tensor(v) or v.ndim != params[i].ndim:
                    continue
                if gather:
                    out[i][name] = pmesh.gather_full(v, spec, mesh)
                else:
                    out[i][name] = v[pmesh.shard_slices(spec, v.shape, mesh)].clone()
        return out

    @torch.no_grad()
    def arm_training_state(self, opt_state: dict, global_step: int = 0, mesh=None) -> None:
        """Install restored optimizer state (:meth:`training_state`'s
        ``opt_state``) and the step count, so that the next ``fit`` continues
        from them. The model must be built and compiled with the optimizer
        the state came from. Each slot is copied into the tensor the
        optimizer holds (its dtype and address kept); slots the optimizer has
        not made yet (Adam's before its first step) are loaded through
        ``load_state_dict`` and packed anew. Every captured chunk graph is
        dropped either way, so that no replay reads a tensor of before.
        ``mesh``: the one the next ``fit(mesh=)`` trains on, on which the
        model is placed already (``CheckpointManager.restore_training``
        places it); ``opt_state`` is whole and each rank keeps its slices."""
        if not self._compiled:
            raise ValueError("compile() the model before arm_training_state")
        if mesh is None and pmesh.state_mesh(self) is not None:
            raise ValueError("the model is placed on a mesh: pass it as mesh=")
        if isinstance(self._optimizer_spec, MultiOptimizer) or self.frozen_blocks():
            raise ValueError("a MultiOptimizer or frozen-block fit starts from fresh slots at "
                             "step 0: its training state cannot be armed")
        if self._optimizer is None:
            self._build_optimizer()
        inner = self._inner_optimizer()
        live = inner.state_dict()["state"]
        if pmesh.state_mesh(self) is not None:
            opt_state = self._mesh_opt_state(inner, opt_state, gather=False)
        same = set(live) == set(opt_state) and all(
            set(live[i]) == set(opt_state[i]) and all(
                torch.is_tensor(v) == torch.is_tensor(opt_state[i][n])
                and (not torch.is_tensor(v) or v.shape == opt_state[i][n].shape)
                for n, v in live[i].items())
            for i in live)
        if same:
            params = [p for g in inner.param_groups for p in g["params"]]
            for i, slots in live.items():
                for name, value in slots.items():
                    if torch.is_tensor(value):
                        value.copy_(opt_state[i][name])
                    else:
                        inner.state[params[i]][name] = opt_state[i][name]
        elif opt_state:
            inner.load_state_dict({"state": opt_state,
                                   "param_groups": inner.state_dict()["param_groups"]})
            repack = getattr(self._optimizer, "_pack", None)
            if repack is not None:
                repack()
        self._step = int(global_step)
        self._mesh = mesh
        self._fit_mesh_fp = None if mesh is None else mesh.fingerprint
        self._chunk_graphs.clear()
        self._group_graphs.clear()


class Model(BaseModel):
    """A sequential container of blocks (or functions, or registered names:
    ``as_block``) ending in a head or a block of heads, with an optional
    ``pre`` and ``post`` block around them; ``schema`` defaults to the
    first block's."""

    def __init__(self, *blocks, schema=None, pre=None, post=None):
        super().__init__()
        blocks = [as_block(b) for b in blocks]
        self.blocks = nn.ModuleList(blocks)
        self.pre = as_block(pre) if pre is not None else None
        self.post = as_block(post) if post is not None else None
        self.schema = schema
        for b in blocks:
            if schema is None and getattr(b, "schema", None) is not None:
                self.schema = b.schema
                break

    @classmethod
    def from_block(cls, block, schema=None, **kwargs) -> "Model":
        return cls(block, schema=schema, **kwargs)

    @property
    def first(self) -> nn.Module:
        return self.blocks[0]

    @property
    def last(self) -> nn.Module:
        return self.blocks[-1]

    def forward(self, inputs, **kwargs):
        kwargs.setdefault("context", ModelContext(features=inputs))
        # subclasses that make their blocks themselves may have no pre / post
        pre, post = getattr(self, "pre", None), getattr(self, "post", None)
        out = inputs if pre is None else call_block(pre, inputs, **kwargs)
        for block in self.blocks:
            out = call_block(block, out, **kwargs)
        return out if post is None else call_block(post, out, **kwargs)


class ModelBlock(Model):
    """Any block (ending in a head) as a trainable model."""
