"""Torch models over the schema and Loader (``models_tpu/torch_backend/
models.py``; reference ``merlin/models/torch/models/{base,ranking}.py``,
rebuilt without Lightning: a plain torch training loop behind the
MerlinModel protocol). A model lives on the device its constructor resolves
(``device=``, default the card); ``fit``, ``evaluate`` and ``predict`` take
the same ``device=``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.device import check_module_device, resolve_device
from ..core.types import SequenceFeature
from ..data.dataset import Dataset
from ..data.loader import Loader, ROW_VALID_KEY
from ..schema import Schema, Tags, infer_embedding_dim


def _torch():
    import torch

    return torch


class _TabularEmbedding:
    """Schema-driven embeddings + continuous concat for torch."""

    def __init__(self, schema: Schema, dim: Optional[int] = None, device=None):
        torch = _torch()
        import torch.nn as nn

        self.device = resolve_device(device)
        self.schema = schema.excluding_by_tag(Tags.TARGET)
        self.cat_cols = list(self.schema.categorical)
        self.cont_cols = list(self.schema.continuous)
        self.tables = nn.ModuleDict()
        self.out_dim = 0
        for col in self.cat_cols:
            d = dim or infer_embedding_dim(col)
            self.tables[col.name] = nn.Embedding(col.cardinality, d)
            self.out_dim += d
        self.out_dim += len(self.cont_cols)

    def _embed_one(self, col, batch):
        torch = _torch()

        v = batch[col.name]
        if isinstance(v, SequenceFeature):
            ids = torch.as_tensor(np.asarray(v.values), dtype=torch.long, device=self.device)
            mask = torch.as_tensor(np.asarray(v.mask), dtype=torch.float32, device=self.device)
            emb = self.tables[col.name](ids)
            return (emb * mask.unsqueeze(-1)).sum(1) / mask.sum(1).clamp(min=1).unsqueeze(-1)
        return self.tables[col.name](torch.as_tensor(np.asarray(v), dtype=torch.long,
                                                     device=self.device))

    def continuous(self, batch):
        """(B, n_cont) float tensor (empty second dim when no continuous cols)."""
        torch = _torch()

        parts = []
        for col in self.cont_cols:
            v = batch[col.name]
            arr = np.asarray(v.values if isinstance(v, SequenceFeature) else v, dtype=np.float32)
            t = torch.as_tensor(arr, device=self.device)
            if t.dim() == 1:
                t = t.unsqueeze(-1)
            if t.dim() == 3:
                t = t.mean(1)
            parts.append(t)
        if not parts:
            n = len(np.atleast_1d(np.asarray(batch[self.cat_cols[0].name])))
            return torch.zeros((n, 0), device=self.device)
        return torch.cat(parts, dim=-1)

    def stacked(self, batch):
        """Per-feature embeddings stacked to (B, F, D) — requires a uniform dim
        (the DLRM contract)."""
        torch = _torch()

        embs = [self._embed_one(col, batch) for col in self.cat_cols]
        return torch.stack(embs, dim=1)

    def __call__(self, batch: Dict[str, np.ndarray]):
        torch = _torch()

        parts = [self._embed_one(col, batch) for col in self.cat_cols]
        cont = self.continuous(batch)
        if cont.shape[-1]:
            parts.append(cont)
        return torch.cat(parts, dim=-1)


class TorchModel:
    """fit/evaluate/predict over a torch module body + binary/regression heads."""

    def __init__(self, schema: Schema, body_factory, head_dim: int, device=None):
        torch = _torch()
        import torch.nn as nn

        self.schema = schema
        self.embedding = _TabularEmbedding(schema, device=device)
        self.body = body_factory(self.embedding.out_dim)
        self.targets = schema.targets.column_names
        self.heads = nn.ModuleDict({t: nn.Linear(head_dim, 1) for t in self.targets})
        self._modules = nn.ModuleList([self.embedding.tables, self.body, self.heads])
        self._modules.to(self.embedding.device)

    def _device(self, device):
        """``device`` resolved, and checked to be the one the model lives on."""
        return check_module_device(self._modules, device)

    def forward(self, batch):
        x = self.embedding(batch)
        h = self.body(x)
        return {t: self.heads[t](h).squeeze(-1) for t in self.targets}

    # ------------------------------------------------------------------
    def fit(self, data: Union[Dataset, Loader], epochs: int = 1, batch_size: int = 256,
            learning_rate: float = 1e-3, verbose: int = 0, device=None):
        torch = _torch()

        dev = self._device(device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size, shuffle=True)
        opt = torch.optim.Adam(self._modules.parameters(), lr=learning_rate)
        bce = torch.nn.BCEWithLogitsLoss()
        history = {"loss": []}
        for epoch in range(epochs):
            total, count = 0.0, 0
            for x, y in loader:
                logits = self.forward(x)
                losses = []
                for t in self.targets:
                    target = torch.as_tensor(
                        np.asarray(y[t] if isinstance(y, dict) else y), dtype=torch.float32,
                        device=dev)
                    losses.append(bce(logits[t], target))
                loss = sum(losses)
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

    def evaluate(self, data: Union[Dataset, Loader], batch_size: int = 256,
                 device=None) -> Dict[str, float]:
        """Binary accuracy + AUC + logloss per task (the reference torch stack
        evaluates with torchmetrics AUROC; AUC here is the exact rank statistic)."""
        torch = _torch()

        self._device(device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        probs = {t: [] for t in self.targets}
        labels = {t: [] for t in self.targets}
        with torch.no_grad():
            for x, y in loader:
                valid = np.asarray(x[ROW_VALID_KEY])
                logits = self.forward(x)
                for t in self.targets:
                    target = np.asarray(y[t] if isinstance(y, dict) else y)
                    p = torch.sigmoid(logits[t]).cpu().numpy()
                    probs[t].append(p[valid])
                    labels[t].append(target[valid])
        out: Dict[str, float] = {}
        for t in self.targets:
            p = np.concatenate(probs[t])
            lab = np.concatenate(labels[t]).astype(np.float64)
            out[f"{t}/binary_accuracy"] = float(((p > 0.5) == lab).mean())
            pos, neg = int(lab.sum()), int((1 - lab).sum())
            if pos and neg:
                ranks = np.argsort(np.argsort(p)) + 1.0  # average-free rank AUC
                out[f"{t}/auc"] = float(
                    (ranks[lab > 0.5].sum() - pos * (pos + 1) / 2) / (pos * neg)
                )
            eps = 1e-7
            pc = np.clip(p, eps, 1 - eps)
            out[f"{t}/logloss"] = float(
                -(lab * np.log(pc) + (1 - lab) * np.log(1 - pc)).mean()
            )
        return out

    def predict(self, data: Union[Dataset, Loader, dict], batch_size: int = 256, device=None):
        torch = _torch()

        self._device(device)
        if isinstance(data, dict):
            with torch.no_grad():
                logits = self.forward(data)
            return {t: torch.sigmoid(v).cpu().numpy() for t, v in logits.items()}
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        chunks = {t: [] for t in self.targets}
        with torch.no_grad():
            for x, _ in loader:
                valid = np.asarray(x[ROW_VALID_KEY])
                logits = self.forward(x)
                for t in self.targets:
                    chunks[t].append(torch.sigmoid(logits[t]).cpu().numpy()[valid])
        return {t: np.concatenate(v) for t, v in chunks.items()}

    def save(self, path: str):
        import os

        torch = _torch()
        os.makedirs(path, exist_ok=True)
        torch.save(self._modules.state_dict(), os.path.join(path, "weights.pt"))
        self.schema.save(os.path.join(path, "schema.json"))

    def load_weights(self, path: str):
        import os

        torch = _torch()
        self._modules.load_state_dict(torch.load(os.path.join(path, "weights.pt"),
                                                 map_location=self.embedding.device))
        return self


def TorchMLPModel(schema: Schema, dims: Sequence[int] = (64, 32), device=None) -> TorchModel:
    import torch.nn as nn

    def body(in_dim):
        layers: List = []
        prev = in_dim
        for d in dims:
            layers += [nn.Linear(prev, d), nn.ReLU()]
            prev = d
        return nn.Sequential(*layers)

    return TorchModel(schema, body, head_dim=dims[-1], device=device)


class TorchDLRMModel(TorchModel):
    """True DLRM (reference ``torch/models/ranking.py:18``): one embedding
    table per categorical feature (shared dim), bottom MLP over continuous
    features projected to the same dim, pairwise dot interactions of the
    stacked feature vectors (+ bottom shortcut), top MLP."""

    def __init__(
        self,
        schema: Schema,
        embedding_dim: int = 16,
        bottom: Sequence[int] = (32,),
        top: Sequence[int] = (64, 32),
        device=None,
    ):
        torch = _torch()
        import torch.nn as nn

        def mlp(prev, dims):
            layers: List = []
            for d in dims:
                layers += [nn.Linear(prev, d), nn.ReLU()]
                prev = d
            return nn.Sequential(*layers)

        self.schema = schema
        self.embedding = _TabularEmbedding(schema, dim=embedding_dim, device=device)
        n_cont = len(self.embedding.cont_cols)
        self.bottom = mlp(n_cont, list(bottom) + [embedding_dim]) if n_cont else None
        F = len(self.embedding.cat_cols) + (1 if self.bottom is not None else 0)
        in_top = F * (F - 1) // 2 + (embedding_dim if self.bottom is not None else 0)
        self.top = mlp(in_top, top)
        self.targets = schema.targets.column_names
        self.heads = nn.ModuleDict({t: nn.Linear(top[-1], 1) for t in self.targets})
        mods = [self.embedding.tables, self.top, self.heads]
        if self.bottom is not None:
            mods.append(self.bottom)
        self._modules = nn.ModuleList(mods)
        self._modules.to(self.embedding.device)

    def forward(self, batch):
        torch = _torch()

        z = self.embedding.stacked(batch)  # (B, F_cat, D)
        parts = [z]
        bottom_out = None
        if self.bottom is not None:
            bottom_out = self.bottom(self.embedding.continuous(batch))  # (B, D)
            parts.append(bottom_out.unsqueeze(1))
        z = torch.cat(parts, dim=1)  # (B, F, D)
        gram = torch.einsum("bfd,bgd->bfg", z, z)
        F = z.shape[1]
        iu = torch.triu_indices(F, F, offset=1, device=gram.device)
        inter = gram[:, iu[0], iu[1]]
        if bottom_out is not None:
            inter = torch.cat([inter, bottom_out], dim=-1)  # bottom shortcut
        h = self.top(inter)
        return {t: self.heads[t](h).squeeze(-1) for t in self.targets}


def TorchDCNModel(schema: Schema, depth: int = 2, deep: Sequence[int] = (64, 32), device=None):
    """DCN-v2 (reference ``torch/models/ranking.py:83``)."""
    import torch
    import torch.nn as nn

    class Body(nn.Module):
        def __init__(self, in_dim):
            super().__init__()
            self.crosses = nn.ModuleList([nn.Linear(in_dim, in_dim) for _ in range(depth)])
            layers: List = []
            prev = in_dim
            for d in deep:
                layers += [nn.Linear(prev, d), nn.ReLU()]
                prev = d
            self.deep = nn.Sequential(*layers)

        def forward(self, x0):
            x = x0
            for lin in self.crosses:
                x = x0 * lin(x) + x
            return self.deep(x)

    return TorchModel(schema, Body, head_dim=deep[-1], device=device)
