"""Torch block DSL (``models_tpu/torch_backend/dsl.py``): the reference's
second full stack, compactly, on the port's schema, Dataset and Loader.

Reference: ``merlin/models/torch/block.py:42-670`` (Block/ParallelBlock/
ResidualBlock/ShortcutBlock/repeat), ``torch/batch.py:26,135`` (Sequence/
Batch), ``torch/inputs/tabular.py:32`` (TabularInputBlock), ``torch/inputs/
embedding.py`` (EmbeddingTable[s]), ``torch/outputs/*`` (ModelOutput,
BinaryOutput, RegressionOutput, CategoricalOutput, TabularOutputBlock),
``torch/models/base.py:45`` (Model), ``torch/predict.py`` (batch prediction).

Rebuilt torch-idiomatically without Lightning/Dask: blocks are plain
``nn.Module``s composed by containers that thread an optional :class:`Batch`
(features/targets/sequence masks) alongside the activations — the same
double-input convention as the reference (``forward(inputs, batch=None)``).
Schema-driven construction (cardinalities, tags, routing) comes from the
port's ``schema``. A :class:`Model` lives on the device its constructor
resolves (``device=``, default the card, raising without one unless given
``"cpu"``); ``fit``, ``evaluate``, ``predict`` and ``encode`` take the same
``device=`` and move each host batch there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence as Seq, Union

import numpy as np

from ..core.device import check_module_device, resolve_device
from ..core.types import SequenceFeature
from ..schema import ColumnSchema, Schema, Tags, infer_embedding_dim

import torch
import torch.nn as nn


# ---------------------------------------------------------------------------
# Batch (reference torch/batch.py:26,135)
# ---------------------------------------------------------------------------

@dataclass
class TorchSequence:
    """Padded sequence values + masks (reference ``Sequence``)."""

    lengths: Dict[str, torch.Tensor] = field(default_factory=dict)
    masks: Dict[str, torch.Tensor] = field(default_factory=dict)

    def length(self, name: str) -> torch.Tensor:
        return self.lengths[name]

    def mask(self, name: str) -> torch.Tensor:
        return self.masks[name]


@dataclass
class Batch:
    """Features/targets/sequence-info triple threaded through blocks
    (reference ``Batch:135``). ``from_loader_batch`` adapts the Loader's
    numpy batches (SequenceFeature → padded tensor + mask) onto ``device``
    (default the CPU, where the host batch lies)."""

    features: Dict[str, torch.Tensor] = field(default_factory=dict)
    targets: Dict[str, torch.Tensor] = field(default_factory=dict)
    sequences: TorchSequence = field(default_factory=TorchSequence)

    @classmethod
    def from_loader_batch(cls, x, y=None, device=None) -> "Batch":
        def put(v):
            return torch.as_tensor(np.asarray(v), device=device)

        feats: Dict[str, torch.Tensor] = {}
        seqs = TorchSequence()
        for name, v in x.items():
            if isinstance(v, SequenceFeature):
                feats[name] = put(v.values)
                m = put(v.mask)
                seqs.masks[name] = m
                seqs.lengths[name] = m.sum(-1)
            else:
                feats[name] = put(v)
        targets: Dict[str, torch.Tensor] = {}
        if isinstance(y, dict):
            targets = {k: put(v) for k, v in y.items()}
        elif y is not None:
            targets = {"target": put(y)}
        return cls(features=feats, targets=targets, sequences=seqs)

    def flatten_as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.features)


def _call(module: nn.Module, inputs, batch: Optional[Batch]):
    """Call with the double-input convention when the module accepts it."""
    import inspect

    try:
        sig = inspect.signature(module.forward)
        if "batch" in sig.parameters:
            return module(inputs, batch=batch)
    except (ValueError, TypeError):
        pass
    return module(inputs)


# ---------------------------------------------------------------------------
# containers (reference torch/block.py:42-670)
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """Sequential container threading (inputs, batch) (reference ``Block:42``)."""

    def __init__(self, *modules: nn.Module, name: Optional[str] = None):
        super().__init__()
        self.values = nn.ModuleList(modules)
        self._name = name

    def forward(self, inputs, batch: Optional[Batch] = None):
        out = inputs
        for m in self.values:
            out = _call(m, out, batch)
        return out

    def append(self, module: nn.Module) -> "Block":
        self.values.append(module)
        return self

    def prepend(self, module: nn.Module) -> "Block":
        self.values.insert(0, module)
        return self

    def repeat(self, n: int = 1) -> "Block":
        """n deep copies chained (reference ``repeat:678``)."""
        import copy

        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        return Block(*[copy.deepcopy(self) for _ in range(n)])

    def __getitem__(self, idx: int) -> nn.Module:
        return self.values[idx]

    def __len__(self) -> int:
        return len(self.values)


class ParallelBlock(Block):
    """Named branches over one input → dict of outputs, optional post
    aggregation (reference ``ParallelBlock:125``). Dict inputs route to
    same-named branches when keys match; otherwise every branch sees the full
    input."""

    def __init__(self, branches: Union[Dict[str, nn.Module], Seq[nn.Module]],
                 agg: Optional[nn.Module] = None):
        super().__init__()
        if not isinstance(branches, dict):
            branches = {str(i): b for i, b in enumerate(branches)}
        self.branches = nn.ModuleDict(branches)
        self.agg = agg

    def forward(self, inputs, batch: Optional[Batch] = None):
        out = {}
        for name, branch in self.branches.items():
            if isinstance(inputs, dict) and set(inputs) >= {name} and len(self.branches) == len(inputs):
                branch_in = inputs[name]
            else:
                branch_in = inputs
            res = _call(branch, branch_in, batch)
            if isinstance(res, dict):
                out.update(res)
            else:
                out[name] = res
        if self.agg is not None:
            return _call(self.agg, out, batch)
        return out

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.branches[key]
        return super().__getitem__(key)

    def keys(self):
        return self.branches.keys()

    def repeat_parallel(self, n: int = 1, agg=None) -> "ParallelBlock":
        import copy

        return ParallelBlock(
            {f"{k}_{i}": copy.deepcopy(v) for i in range(n) for k, v in self.branches.items()},
            agg=agg,
        )


class ResidualBlock(Block):
    """out = shortcut(x) + block(x) (reference ``ResidualBlock:417``)."""

    def __init__(self, *modules: nn.Module, activation: Optional[Callable] = None):
        super().__init__(*modules)
        self.activation = activation

    def forward(self, inputs, batch: Optional[Batch] = None):
        out = super().forward(inputs, batch=batch)
        out = inputs + out
        return self.activation(out) if self.activation else out


class ShortcutBlock(Block):
    """Return {'output': block(x), 'shortcut': x} (reference ``:454``)."""

    def __init__(self, *modules: nn.Module, output_name: str = "output",
                 shortcut_name: str = "shortcut"):
        super().__init__(*modules)
        self.output_name = output_name
        self.shortcut_name = shortcut_name

    def forward(self, inputs, batch: Optional[Batch] = None):
        out = super().forward(inputs, batch=batch)
        return {self.output_name: out, self.shortcut_name: inputs}


# ---------------------------------------------------------------------------
# aggregations (reference torch/transforms/agg.py)
# ---------------------------------------------------------------------------

class Concat(nn.Module):
    """Concat a dict of (B, ...) tensors on the last axis, sorted by key
    (deterministic like the JAX stack's sorted aggregations)."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = []
        for k in sorted(inputs):
            t = inputs[k]
            if t.dim() == 1:
                t = t.unsqueeze(-1)
            parts.append(t)
        return torch.cat(parts, dim=self.dim)


class Stack(nn.Module):
    def __init__(self, dim: int = 1):
        super().__init__()
        self.dim = dim

    def forward(self, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([inputs[k] for k in sorted(inputs)], dim=self.dim)


# ---------------------------------------------------------------------------
# inputs (reference torch/inputs/{select,embedding,tabular}.py)
# ---------------------------------------------------------------------------

class SelectKeys(nn.Module):
    """Filter a feature dict by schema (reference ``SelectKeys``)."""

    def __init__(self, schema: Schema):
        super().__init__()
        self.schema = schema
        self.names = set(schema.column_names)

    def forward(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in inputs.items() if k in self.names}


class EmbeddingTable(nn.Module):
    """Single table, multiple features allowed; sequence ids mean-pooled with
    their mask (reference ``torch/inputs/embedding.py`` EmbeddingTable)."""

    def __init__(self, dim: int, col_schema: Union[ColumnSchema, Seq[ColumnSchema]],
                 seq_combiner: str = "mean"):
        super().__init__()
        cols = [col_schema] if isinstance(col_schema, ColumnSchema) else list(col_schema)
        self.cols = cols
        self.dim = dim
        self.seq_combiner = seq_combiner
        self.table = nn.Embedding(cols[0].cardinality, dim)

    def forward(self, inputs, batch: Optional[Batch] = None):
        if isinstance(inputs, dict):
            return {c.name: self._one(c.name, inputs[c.name], batch)
                    for c in self.cols if c.name in inputs}
        return self._one(self.cols[0].name, inputs, batch)

    def _one(self, name: str, ids: torch.Tensor, batch: Optional[Batch]):
        emb = self.table(ids.long())
        if emb.dim() == 3:
            mask = None
            if batch is not None and name in batch.sequences.masks:
                mask = batch.sequences.masks[name].to(emb.dtype)
            if self.seq_combiner == "mean":
                if mask is None:
                    return emb.mean(1)
                return (emb * mask.unsqueeze(-1)).sum(1) / mask.sum(1).clamp(min=1).unsqueeze(-1)
            if self.seq_combiner == "sum":
                if mask is None:
                    return emb.sum(1)
                return (emb * mask.unsqueeze(-1)).sum(1)
        return emb


def EmbeddingTables(schema: Schema, dim: Optional[Union[int, Dict[str, int]]] = None,
                    seq_combiner: str = "mean") -> ParallelBlock:
    """One table per categorical domain (reference ``EmbeddingTables``)."""
    cat = schema.categorical
    by_domain: Dict[str, List[ColumnSchema]] = {}
    for col in cat:
        by_domain.setdefault(col.domain_name, []).append(col)
    tables = {}
    for domain, cols in by_domain.items():
        if isinstance(dim, dict):
            d = dim.get(domain) or infer_embedding_dim(cols[0])
        else:
            d = dim or infer_embedding_dim(cols[0])
        tables[domain] = EmbeddingTable(d, cols, seq_combiner=seq_combiner)
    return ParallelBlock(tables)


class TabularInputBlock(ParallelBlock):
    """Schema-routed input block (reference ``torch/inputs/tabular.py:32``):
    categorical → embeddings, continuous → float passthrough, aggregated by
    ``agg`` ("concat" default)."""

    def __init__(self, schema: Schema, dim: Optional[int] = None,
                 agg: Union[str, nn.Module, None] = "concat",
                 seq_combiner: str = "mean"):
        feat = schema.excluding_by_tag(Tags.TARGET)
        branches: Dict[str, nn.Module] = {}
        if len(feat.categorical):
            branches["categorical"] = Block(
                SelectKeys(feat.categorical), EmbeddingTables(feat.categorical, dim,
                                                              seq_combiner=seq_combiner)
            )
        if len(feat.continuous):
            branches["continuous"] = Block(SelectKeys(feat.continuous), _AsFloat())
        if isinstance(agg, str):
            agg = {"concat": Concat(), "stack": Stack()}[agg]
        super().__init__(branches, agg=agg)
        self.schema = feat
        # output width for downstream lazy-free construction
        out = 0
        for col in feat.categorical:
            out += dim or infer_embedding_dim(col)
        out += len(list(feat.continuous))
        self.out_dim = out


class _AsFloat(nn.Module):
    def forward(self, inputs, batch: Optional[Batch] = None):
        out = {}
        for k, v in inputs.items():
            t = v.float()
            if t.dim() == 3:  # pooled sequence continuous
                if batch is not None and k in batch.sequences.masks:
                    m = batch.sequences.masks[k].to(t.dtype).unsqueeze(-1)
                    t = (t * m).sum(1) / m.sum(1).clamp(min=1)
                else:
                    t = t.mean(1)
            elif t.dim() == 2 and batch is not None and k in batch.sequences.masks:
                m = batch.sequences.masks[k].to(t.dtype)
                t = (t * m).sum(1, keepdim=True) / m.sum(1, keepdim=True).clamp(min=1)
            if t.dim() == 1:
                t = t.unsqueeze(-1)
            out[k] = t
        return out


# ---------------------------------------------------------------------------
# architecture blocks (reference torch/blocks/{mlp,dlrm,cross}.py)
# ---------------------------------------------------------------------------

def MLPBlock(units: Seq[int], in_dim: int, activation=nn.ReLU,
             dropout: float = 0.0) -> Block:
    """(reference ``torch/blocks/mlp.py`` MLPBlock — built eagerly from a
    known in_dim; schemas make input widths static)."""
    layers: List[nn.Module] = []
    prev = in_dim
    for d in units:
        layers.append(nn.Linear(prev, d))
        layers.append(activation())
        if dropout:
            layers.append(nn.Dropout(dropout))
        prev = d
    blk = Block(*layers)
    blk.out_dim = prev
    return blk


class CrossBlock(nn.Module):
    """DCN-v2 crosses: x_{i+1} = x0 * (W x_i + b) + x_i (reference
    ``torch/blocks/cross.py``); optional low-rank factorization."""

    def __init__(self, in_dim: int, depth: int = 1, low_rank: Optional[int] = None):
        super().__init__()
        if low_rank:
            self.layers = nn.ModuleList([
                nn.Sequential(nn.Linear(in_dim, low_rank, bias=False),
                              nn.Linear(low_rank, in_dim))
                for _ in range(depth)
            ])
        else:
            self.layers = nn.ModuleList([nn.Linear(in_dim, in_dim) for _ in range(depth)])

    def forward(self, x0, batch: Optional[Batch] = None):
        x = x0
        for lin in self.layers:
            x = x0 * lin(x) + x
        return x


class DLRMBlock(nn.Module):
    """DLRM interaction body (reference ``torch/blocks/dlrm.py``): per-feature
    embeddings at one dim, bottom MLP over continuous → same dim, pairwise dot
    interactions + bottom shortcut, top handled by the caller."""

    def __init__(self, schema: Schema, dim: int = 16, bottom_block: Seq[int] = (32,)):
        super().__init__()
        feat = schema.excluding_by_tag(Tags.TARGET)
        self.cat_schema = feat.categorical
        self.embeddings = EmbeddingTables(self.cat_schema, dim)
        self.cont = Block(SelectKeys(feat.continuous), _AsFloat()) if len(feat.continuous) else None
        n_cont = len(list(feat.continuous))
        self.bottom = (
            MLPBlock(list(bottom_block) + [dim], n_cont) if n_cont else None
        )
        # count FEATURES, not tables: EmbeddingTables groups shared domains
        # into one branch, but forward() emits one vector per feature, so two
        # features sharing a domain still contribute two interaction rows
        F = len(list(self.cat_schema)) + (1 if self.bottom is not None else 0)
        self.out_dim = F * (F - 1) // 2 + (dim if self.bottom is not None else 0)

    def forward(self, inputs: Dict[str, torch.Tensor], batch: Optional[Batch] = None):
        embs = self.embeddings({k: v for k, v in inputs.items()
                                if k in set(self.cat_schema.column_names)}, batch=batch)
        z = torch.stack([embs[k] for k in sorted(embs)], dim=1)  # (B, F, D)
        bottom_out = None
        if self.bottom is not None:
            cont = Concat()(self.cont(inputs, batch=batch))
            bottom_out = self.bottom(cont)
            z = torch.cat([z, bottom_out.unsqueeze(1)], dim=1)
        gram = torch.einsum("bfd,bgd->bfg", z, z)
        F = z.shape[1]
        iu = torch.triu_indices(F, F, offset=1, device=gram.device)
        inter = gram[:, iu[0], iu[1]]
        if bottom_out is not None:
            inter = torch.cat([inter, bottom_out], dim=-1)
        return inter


# ---------------------------------------------------------------------------
# outputs (reference torch/outputs/*)
# ---------------------------------------------------------------------------

class ModelOutput(Block):
    """Head base: target column binding + default loss (reference
    ``torch/outputs/base.py:28``)."""

    def __init__(self, *modules: nn.Module, target: Optional[str] = None,
                 loss: Optional[nn.Module] = None):
        super().__init__(*modules)
        self.target = target
        self.loss = loss

    def output_activation(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def compute_loss(self, out: torch.Tensor, batch: "Batch") -> Optional[torch.Tensor]:
        """Heads that derive their own loss target (e.g. contrastive CE
        against column 0) override this; ``None`` means "use the standard
        target-column routing" in ``Model._head_losses``."""
        return None


class BinaryOutput(ModelOutput):
    """Sigmoid head (reference ``torch/outputs/classification.py:31``)."""

    def __init__(self, col: Union[str, ColumnSchema], in_dim: int):
        name = col if isinstance(col, str) else col.name
        super().__init__(nn.Linear(in_dim, 1), target=name,
                         loss=nn.BCEWithLogitsLoss())

    def output_activation(self, t):
        return torch.sigmoid(t)


class RegressionOutput(ModelOutput):
    """Linear head (reference ``torch/outputs/regression.py``)."""

    def __init__(self, col: Union[str, ColumnSchema], in_dim: int):
        name = col if isinstance(col, str) else col.name
        super().__init__(nn.Linear(in_dim, 1), target=name, loss=nn.MSELoss())


class CategoricalOutput(ModelOutput):
    """num_classes softmax head (reference ``classification.py:101``)."""

    def __init__(self, col: ColumnSchema, in_dim: int):
        super().__init__(nn.Linear(in_dim, col.cardinality), target=col.name,
                         loss=nn.CrossEntropyLoss())

    def output_activation(self, t):
        return torch.softmax(t, dim=-1)


def TabularOutputBlock(schema: Schema, in_dim: int) -> ParallelBlock:
    """One head per target column by tag (reference
    ``torch/outputs/tabular.py`` TabularOutputBlock)."""
    heads: Dict[str, nn.Module] = {}
    for col in schema.targets:
        tags = [str(t) for t in col.tags]
        card = col.cardinality
        if str(Tags.REGRESSION) in tags or col.dtype.startswith("float"):
            heads[col.name] = RegressionOutput(col, in_dim)
        elif str(Tags.CATEGORICAL) in tags and card and card > 2:
            # multi-class target (reference routes Tags.CATEGORICAL to
            # CategoricalOutput, torch/outputs/tabular.py) — a sigmoid head
            # here would silently train BCE against class *indices*
            heads[col.name] = CategoricalOutput(col, in_dim)
        else:
            heads[col.name] = BinaryOutput(col, in_dim)
    if not heads:
        raise ValueError("schema has no target columns")
    return ParallelBlock(heads)


# ---------------------------------------------------------------------------
# Model (reference torch/models/base.py:45) — plain torch loop, no Lightning
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Sequential blocks ending in ModelOutput head(s), with
    fit/evaluate/predict over the Loader (reference ``Model:45``; the
    Lightning Trainer collapses into a plain loop). The blocks move to
    ``device`` (default the card)."""

    def __init__(self, *blocks: nn.Module, schema: Optional[Schema] = None, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.schema = schema
        self.to(resolve_device(device))

    def forward(self, inputs, batch: Optional[Batch] = None):
        out = inputs
        for b in self.blocks:
            out = _call(b, out, batch)
        return out

    # -- helpers ---------------------------------------------------------
    def model_outputs(self) -> List[ModelOutput]:
        outs: List[ModelOutput] = []

        def walk(m):
            if isinstance(m, ModelOutput):
                outs.append(m)
                return
            for c in m.children():
                walk(c)

        walk(self)
        return outs

    def _head_losses(self, raw, batch: Batch):
        heads = {h.target: h for h in self.model_outputs()}
        if not isinstance(raw, dict):
            raw = {next(iter(heads)): raw}
        targets = dict(batch.targets)
        if "target" in targets and len(heads) == 1:
            # the loader yields a bare array for single-target data
            targets[next(iter(heads))] = targets.pop("target")
        losses = {}
        for name, out in raw.items():
            head = heads.get(name)
            if head is None:
                continue
            custom = head.compute_loss(out, batch)
            if custom is not None:
                losses[name] = custom
                continue
            if name not in targets:
                continue
            target = targets[name]
            if isinstance(head.loss, nn.CrossEntropyLoss):
                losses[name] = head.loss(out, target.long())
            else:
                losses[name] = head.loss(out.squeeze(-1), target.float())
        return losses

    # -- training --------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 256,
            learning_rate: float = 1e-3, verbose: int = 0, device=None):
        from ..data.loader import Loader

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size, shuffle=True)
        opt = torch.optim.Adam(self.parameters(), lr=learning_rate)
        history = {"loss": []}
        self.train()
        for epoch in range(epochs):
            total, count = 0.0, 0
            for x, y in loader:
                batch = Batch.from_loader_batch(x, y, device=dev)
                raw = self.forward(batch.features, batch=batch)
                losses = self._head_losses(raw, batch)
                if not losses:
                    raise ValueError("no head produced a loss — check targets")
                loss = sum(losses.values())
                opt.zero_grad()
                loss.backward()
                opt.step()
                total += float(loss.detach())
                count += 1
            history["loss"].append(total / max(count, 1))
            if verbose:
                print(f"epoch {epoch + 1}: loss={history['loss'][-1]:.4f}")
        self.history = history
        return history

    def evaluate(self, data, batch_size: int = 256, device=None) -> Dict[str, float]:
        from ..data.loader import Loader, ROW_VALID_KEY

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        heads = {h.target: h for h in self.model_outputs()}
        self.eval()
        probs = {t: [] for t in heads}
        labels = {t: [] for t in heads}
        with torch.no_grad():
            for x, y in loader:
                batch = Batch.from_loader_batch(x, y, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                raw = self.forward(batch.features, batch=batch)
                if not isinstance(raw, dict):
                    raw = {next(iter(heads)): raw}
                targets = dict(batch.targets)
                if "target" in targets and len(heads) == 1:
                    targets[next(iter(heads))] = targets.pop("target")
                for t, head in heads.items():
                    if t not in raw or t not in targets:
                        continue
                    p = head.output_activation(raw[t]).squeeze(-1).cpu().numpy()
                    lab = targets[t].cpu().numpy()
                    if valid is not None:
                        p, lab = p[valid], lab[valid]
                    probs[t].append(p)
                    labels[t].append(lab)
        out: Dict[str, float] = {}
        for t, head in heads.items():
            if not probs[t]:
                continue
            p = np.concatenate(probs[t])
            lab = np.concatenate(labels[t]).astype(np.float64)
            if isinstance(head, RegressionOutput):
                out[f"{t}/rmse"] = float(np.sqrt(np.mean((p - lab) ** 2)))
                continue
            out[f"{t}/binary_accuracy"] = float(((p > 0.5) == lab).mean())
            pos, neg = int(lab.sum()), int((1 - lab).sum())
            if pos and neg:
                ranks = np.argsort(np.argsort(p)) + 1.0
                out[f"{t}/auc"] = float(
                    (ranks[lab > 0.5].sum() - pos * (pos + 1) / 2) / (pos * neg)
                )
        return out

    def predict(self, data, batch_size: int = 256, device=None):
        """Batch prediction sweep (the reference's ``predict`` module /
        DaskPredictor — partition-wise encode without Dask)."""
        from ..data.loader import Loader, ROW_VALID_KEY

        dev = check_module_device(self, device)
        heads = {h.target: h for h in self.model_outputs()}
        if isinstance(data, dict):
            batch = Batch.from_loader_batch(data, device=dev)
            with torch.no_grad():
                raw = self.forward(batch.features, batch=batch)
            if not isinstance(raw, dict):
                raw = {next(iter(heads)): raw}
            return {t: heads[t].output_activation(v).squeeze(-1).cpu().numpy()
                    for t, v in raw.items() if t in heads}
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        chunks: Dict[str, List[np.ndarray]] = {t: [] for t in heads}
        with torch.no_grad():
            for x, _ in loader:
                batch = Batch.from_loader_batch(x, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                raw = self.forward(batch.features, batch=batch)
                if not isinstance(raw, dict):
                    raw = {next(iter(heads)): raw}
                for t in heads:
                    if t not in raw:
                        continue
                    p = heads[t].output_activation(raw[t]).squeeze(-1).cpu().numpy()
                    chunks[t].append(p[valid] if valid is not None else p)
        return {t: np.concatenate(v) for t, v in chunks.items() if v}

    # -- persistence -----------------------------------------------------
    def save(self, path: str):
        import os

        os.makedirs(path, exist_ok=True)
        torch.save(self.state_dict(), os.path.join(path, "weights.pt"))
        if self.schema is not None:
            self.schema.save(os.path.join(path, "schema.json"))

    def load_weights(self, path: str) -> "Model":
        import os

        dev = next(iter(self.state_dict().values())).device
        self.load_state_dict(torch.load(os.path.join(path, "weights.pt"), map_location=dev))
        return self


class EncoderBlock(Model):
    """Inference-only composition: forward + batch predict, refuses fit
    (reference ``torch/predict.py:20``)."""

    def fit(self, *a, **k):  # noqa: D102
        raise RuntimeError("EncoderBlock is inference-only (reference EncoderBlock)")

    def encode(self, data, selection=None, batch_size: int = 256,
               index=None, unique: bool = True, device=None):
        """Batch-encode a dataset into embeddings, returned as a
        :class:`~models_tpu_torch.data.Dataset` with a schema — the reference's
        ``DaskEncoder.encode_dataset`` (``torch/predict.py:221``) without Dask:
        partition-wise forward of the PRE-head body output.

        - ``selection``: restrict forward inputs to these columns (a Schema,
          Tags value, or list of names) — the reference's schema-selection;
        - ``index``: column(s) to carry alongside the embeddings (e.g.
          ``Tags.ITEM_ID``); with ``unique=True`` duplicate index rows keep
          their first occurrence (the reference's ``unique`` flag);
        - embedding dims become float columns named ``"0".."D-1"`` tagged
          ``Tags.EMBEDDING``, matching the reference's encoded dataframe.
        """
        import numpy as np

        from ..data.dataset import Dataset
        from ..data.loader import Loader, ROW_VALID_KEY
        from ..schema import ColumnSchema, Schema, Tags

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        schema = self.schema

        def _select_names(sel):
            if sel is None:
                return None
            if isinstance(sel, Schema):
                return list(sel.column_names)
            if isinstance(sel, (list, tuple, set)):
                return list(sel)
            # a Tags value
            return list(schema.select_by_tag(sel).column_names)

        keep = _select_names(selection)
        idx_names = _select_names(index) or []

        emb_chunks: List[np.ndarray] = []
        idx_chunks: Dict[str, List[np.ndarray]] = {n: [] for n in idx_names}
        with torch.no_grad():
            for x, _ in loader:
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                feats = x if keep is None else {
                    k: v for k, v in x.items()
                    if k in keep or k == ROW_VALID_KEY
                }
                batch = Batch.from_loader_batch(feats, device=dev)
                out = self.forward(batch.features, batch=batch)
                if isinstance(out, dict):
                    if len(out) != 1:
                        raise ValueError(
                            "encode() needs a single embedding output; got "
                            f"{sorted(out)} — select a branch or wrap it"
                        )
                    out = next(iter(out.values()))
                arr = out.detach().cpu().numpy()
                if arr.ndim != 2:
                    arr = arr.reshape(arr.shape[0], -1)
                if valid is not None:
                    arr = arr[valid]
                emb_chunks.append(arr)
                for n in idx_names:
                    col = np.asarray(x[n])
                    idx_chunks[n].append(col[valid] if valid is not None else col)

        emb = np.concatenate(emb_chunks)
        data_out: Dict[str, np.ndarray] = {}
        cols: List[ColumnSchema] = []
        for n in idx_names:
            data_out[n] = np.concatenate(idx_chunks[n])
            if schema is not None and n in schema:
                cols.append(schema[n])
        if unique and idx_names:
            _, first = np.unique(data_out[idx_names[0]], return_index=True)
            first = np.sort(first)
            emb = emb[first]
            for n in idx_names:
                data_out[n] = data_out[n][first]
        for d in range(emb.shape[1]):
            data_out[str(d)] = emb[:, d]
            cols.append(ColumnSchema(str(d), tags=(Tags.EMBEDDING.value,),
                                     dtype="float32"))
        return Dataset(data_out, schema=Schema(cols))

    def predict(self, data, selection=None, batch_size: int = 256,
                index=None, prediction_suffix: str = "_prediction",
                unique: bool = True, device=None):
        """Batch-predict keeping ALL scalar input features in the output plus
        suffixed prediction columns — the reference's ``EncoderBlock.predict``
        / ``DaskPredictor`` contract (``torch/predict.py:98-136,439``):

        - every scalar input column rides through to the output Dataset with
          its original schema (list/sequence columns are inference inputs
          only — the reference's TensorTable likewise carries flat columns);
        - dict outputs append one column per key named ``{key}{suffix}``
          (multi-dim values expand to ``{key}{suffix}_{d}``); a lone tensor
          output becomes ``output{suffix}[_{d}]``;
        - ``selection`` narrows the FORWARD inputs (schema selection), not the
          carried columns; ``index``+``unique`` dedups rows by the index
          column, keeping first occurrences, exactly like :meth:`encode`.
        """
        import numpy as np

        from ..core.types import SequenceFeature
        from ..data.dataset import Dataset
        from ..data.loader import Loader, ROW_VALID_KEY
        from ..schema import ColumnSchema, Schema, Tags

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        schema = self.schema

        def _select_names(sel):
            if sel is None:
                return None
            from .tracing import select_schema

            return list(select_schema(schema, sel).column_names)

        keep = _select_names(selection)
        idx_names = _select_names(index) or []

        feat_chunks: Dict[str, List[np.ndarray]] = {}
        pred_chunks: Dict[str, List[np.ndarray]] = {}
        with torch.no_grad():
            for x, _ in loader:
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                feats = x if keep is None else {
                    k: v for k, v in x.items()
                    if k in keep or k == ROW_VALID_KEY
                }
                batch = Batch.from_loader_batch(feats, device=dev)
                out = self.forward(batch.features, batch=batch)
                if not isinstance(out, dict):
                    out = {"output": out}
                for k, v in out.items():
                    arr = v.detach().cpu().numpy()
                    if valid is not None:
                        arr = arr[valid]
                    pred_chunks.setdefault(k, []).append(arr)
                for k, v in x.items():
                    if k == ROW_VALID_KEY or isinstance(v, SequenceFeature):
                        continue
                    col = np.asarray(v)
                    if col.ndim != 1:
                        continue
                    if valid is not None:
                        col = col[valid]
                    feat_chunks.setdefault(k, []).append(col)

        data_out: Dict[str, np.ndarray] = {}
        cols: List[ColumnSchema] = []
        for n, chunks in feat_chunks.items():
            data_out[n] = np.concatenate(chunks)
            cols.append(schema[n] if schema is not None and n in schema
                        else ColumnSchema(n, dtype=str(data_out[n].dtype)))
        for k, chunks in pred_chunks.items():
            arr = np.concatenate(chunks)
            base = f"{k}{prediction_suffix}"
            if arr.ndim == 1 or (arr.ndim == 2 and arr.shape[1] == 1):
                data_out[base] = arr.reshape(-1).astype(np.float32)
                cols.append(ColumnSchema(base, dtype="float32"))
            else:
                arr = arr.reshape(arr.shape[0], -1)
                for d in range(arr.shape[1]):
                    name = f"{base}_{d}"
                    data_out[name] = arr[:, d].astype(np.float32)
                    cols.append(ColumnSchema(name, dtype="float32"))
        if unique and idx_names:
            key = data_out[idx_names[0]]
            _, first = np.unique(key, return_index=True)
            first = np.sort(first)
            data_out = {k: v[first] for k, v in data_out.items()}
        return Dataset(data_out, schema=Schema(cols))


# ---------------------------------------------------------------------------
# model zoo over the DSL (reference torch/models/ranking.py)
# ---------------------------------------------------------------------------

def DLRMModel(schema: Schema, dim: int = 16, bottom_block: Seq[int] = (32,),
              top_block: Seq[int] = (64, 32), device=None) -> Model:
    """(reference ``torch/models/ranking.py:18``)."""
    dev = resolve_device(device)
    body = DLRMBlock(schema, dim=dim, bottom_block=bottom_block)
    top = MLPBlock(top_block, body.out_dim)
    return Model(body, top, TabularOutputBlock(schema, top.out_dim), schema=schema, device=dev)


def DCNModel(schema: Schema, depth: int = 2, deep_block: Seq[int] = (64, 32),
             dim: Optional[int] = None, low_rank: Optional[int] = None, device=None) -> Model:
    """(reference ``torch/models/ranking.py:83``)."""
    dev = resolve_device(device)
    inputs = TabularInputBlock(schema, dim=dim)
    cross = CrossBlock(inputs.out_dim, depth=depth, low_rank=low_rank)
    deep = MLPBlock(deep_block, inputs.out_dim)
    return Model(inputs, cross, deep, TabularOutputBlock(schema, deep.out_dim),
                 schema=schema, device=dev)


def MLPModel(schema: Schema, units: Seq[int] = (64, 32), device=None) -> Model:
    dev = resolve_device(device)
    inputs = TabularInputBlock(schema)
    mlp = MLPBlock(units, inputs.out_dim)
    return Model(inputs, mlp, TabularOutputBlock(schema, mlp.out_dim), schema=schema,
                 device=dev)


# ---------------------------------------------------------------------------
# multi-task experts (reference torch/blocks/experts.py) + cross-attention
# ---------------------------------------------------------------------------

def _fresh_copy(module: nn.Module) -> nn.Module:
    """Deep copy with RE-INITIALIZED parameters: identical expert copies make
    every gate mixture identical regardless of gate weights (the same
    init-symmetry bug found and fixed in the JAX experts blocks, r2)."""
    import copy

    new = copy.deepcopy(module)

    def reinit(m):
        if hasattr(m, "reset_parameters"):
            m.reset_parameters()

    new.apply(reinit)
    return new


class _ExpertGate(nn.Module):
    """Softmax gate over stacked expert outputs (reference
    ``ExpertGateBlock:193``): gate logits from the block input, output the
    weighted expert mixture."""

    def __init__(self, in_dim: int, num_experts: int):
        super().__init__()
        self.gate = nn.Linear(in_dim, num_experts)

    def forward(self, inputs: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.gate(inputs), dim=-1)         # (B, E)
        return torch.einsum("be,bed->bd", w, experts)


class MMOEBlock(nn.Module):
    """Multi-gate mixture-of-experts (reference ``MMOEBlock:28``): shared
    experts, one gate per task → dict task → (B, D)."""

    def __init__(self, expert: Block, num_experts: int, in_dim: int, out_dim: int,
                 outputs: Seq[str]):
        super().__init__()
        self.experts = nn.ModuleList(
            [_fresh_copy(expert) for _ in range(num_experts)]
        )
        self.gates = nn.ModuleDict(
            {t: _ExpertGate(in_dim, num_experts) for t in outputs}
        )
        self.out_dim = out_dim

    def forward(self, inputs: torch.Tensor, batch: Optional[Batch] = None):
        stacked = torch.stack([_call(e, inputs, batch) for e in self.experts], dim=1)
        return {t: g(inputs, stacked) for t, g in self.gates.items()}


class CGCBlock(nn.Module):
    """Customized gate control: shared + per-task experts (reference
    ``CGCBlock:138``). With ``shared_gate=True`` (PLE intermediate layers) it
    also emits a ``"shared"`` stream gated over ALL experts, and accepts the
    dict a previous CGC layer produced (per-task + shared streams)."""

    def __init__(self, expert: Block, num_shared: int, num_task: int,
                 in_dim: int, out_dim: int, outputs: Seq[str],
                 shared_gate: bool = False):
        super().__init__()
        self.shared = nn.ModuleList([_fresh_copy(expert) for _ in range(num_shared)])
        self.task_experts = nn.ModuleDict(
            {t: nn.ModuleList([_fresh_copy(expert) for _ in range(num_task)])
             for t in outputs}
        )
        self.gates = nn.ModuleDict(
            {t: _ExpertGate(in_dim, num_shared + num_task) for t in outputs}
        )
        self.shared_gate = (
            _ExpertGate(in_dim, num_shared + num_task * len(outputs))
            if shared_gate else None
        )
        self.out_dim = out_dim

    def forward(self, inputs, batch: Optional[Batch] = None):
        def stream(t):
            return inputs[t] if isinstance(inputs, dict) else inputs

        shared_in = inputs["shared"] if isinstance(inputs, dict) else inputs
        shared = [_call(e, shared_in, batch) for e in self.shared]
        out = {}
        task_outs: List[torch.Tensor] = []
        for t, gate in self.gates.items():
            own = [_call(e, stream(t), batch) for e in self.task_experts[t]]
            task_outs.extend(own)
            out[t] = gate(stream(t), torch.stack(shared + own, dim=1))
        if self.shared_gate is not None:
            out["shared"] = self.shared_gate(
                shared_in, torch.stack(shared + task_outs, dim=1)
            )
        return out


def PLEBlock(expert_factory: Callable[..., Block], num_shared: int, num_task: int,
             depth: int, in_dim: int, out_dim: int, outputs: Seq[str]) -> Block:
    """Progressive layered extraction = ``depth`` stacked CGC layers
    (reference ``PLEBlock:79``): intermediate layers keep a gated shared
    stream alongside the per-task streams; the final layer emits per-task
    only. ``expert_factory`` may take the layer's input dim as its single
    argument (layers past the first see ``out_dim``-wide inputs); a zero-arg
    factory requires ``in_dim == out_dim`` when ``depth > 1``."""
    import inspect

    try:
        takes_dim = len(inspect.signature(expert_factory).parameters) >= 1
    except (TypeError, ValueError):
        takes_dim = False
    if depth > 1 and in_dim != out_dim and not takes_dim:
        raise ValueError(
            "PLEBlock(depth>1) with in_dim != out_dim needs an expert_factory "
            "that accepts the layer input dim (layers past the first consume "
            f"{out_dim}-wide streams, the first consumes {in_dim})"
        )
    layers: List[nn.Module] = []
    d = in_dim
    for i in range(depth):
        expert = expert_factory(d) if takes_dim else expert_factory()
        layers.append(
            CGCBlock(expert, num_shared, num_task, d, out_dim, outputs,
                     shared_gate=i < depth - 1)
        )
        d = out_dim
    return Block(*layers)


class CrossAttentionBlock(nn.Module):
    """Cross-attention of a query sequence over a context sequence (reference
    ``torch/blocks/attention.py:11``)."""

    def __init__(self, d_model: int, n_heads: int = 4):
        super().__init__()
        self.attn = nn.MultiheadAttention(d_model, n_heads, batch_first=True)
        self.norm = nn.LayerNorm(d_model)

    def forward(self, inputs, batch: Optional[Batch] = None):
        if isinstance(inputs, dict):
            q, kv = inputs["query"], inputs["context"]
        else:
            q = kv = inputs
        out, _ = self.attn(q, kv, kv)
        return self.norm(q + out)
