"""Torch-backend sequence transforms + session model
(``models_tpu/torch_backend/sequences.py``).

Mirrors the reference torch stack's sequence machinery:

- ``TabularPredictNext`` / ``TabularPredictLast`` — causal-LM style target
  derivation on padded Batch sequences (reference
  ``merlin/models/torch/transforms/sequences.py:343-526``,
  ``TabularPredictNext``/``TabularSequenceTransform``).
- ``TabularMaskRandom`` / ``TabularMaskLast`` — BERT-style masked-LM target
  selection (the reference TF twins ``tf/transforms/sequence.py:589,804``;
  the torch reference reaches the same behavior through its masking
  transforms).
- ``SessionTransformerModel`` — item sequence → torch TransformerEncoder →
  tied-softmax next-item head, trained with the transforms above and able to
  batch-predict session embeddings (reference ``torch/predict.py``'s
  encoder sweep, without Dask).

All transforms consume and produce :class:`~.dsl.Batch` (padded values +
explicit masks), on the batch's device. Random draws take an explicit
``torch.Generator`` where given (else the global one, as the JAX package's
copy draws).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence as Seq

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from ..core.device import check_module_device, resolve_device
from ..schema import ColumnSchema, Schema, Tags, infer_embedding_dim
from .dsl import Batch, Model, ModelOutput, TorchSequence


def _copy_batch(batch: Batch) -> Batch:
    return Batch(
        features=dict(batch.features),
        targets=dict(batch.targets),
        sequences=TorchSequence(
            lengths=dict(batch.sequences.lengths),
            masks=dict(batch.sequences.masks),
        ),
    )


class TabularSequenceTransform(nn.Module):
    """Base: binds the target sequence column and its sibling sequence
    features (reference ``TabularSequenceTransform``)."""

    def __init__(self, schema: Schema, target: str):
        super().__init__()
        self.target = target
        self.seq_names = [
            c.name for c in schema.select_by_tag(Tags.SEQUENCE)
        ] or [target]
        if target not in self.seq_names:
            self.seq_names.append(target)

    def _mask(self, batch: Batch) -> torch.Tensor:
        m = batch.sequences.masks.get(self.target)
        if m is None:
            raise ValueError(
                f"{type(self).__name__}: {self.target!r} has no sequence mask "
                "(is it a list feature?)"
            )
        return m.bool()


class TabularPredictNext(TabularSequenceTransform):
    """Inputs keep positions whose NEXT item exists; target at position t is
    x[t+1] (reference ``TabularPredictNext:343``)."""

    def forward(self, batch: Batch) -> Batch:
        out = _copy_batch(batch)
        vals = batch.features[self.target]
        mask = self._mask(batch)
        shifted = torch.roll(vals, -1, dims=1)
        pred_mask = mask & torch.roll(mask, -1, dims=1)
        pred_mask[:, -1] = False
        for name in self.seq_names:
            if name in out.sequences.masks:
                out.sequences.masks[name] = pred_mask
                out.sequences.lengths[name] = pred_mask.sum(-1)
        out.targets[self.target] = shifted
        return out


class TabularPredictLast(TabularSequenceTransform):
    """Target = last valid item; inputs = the prefix before it (reference
    ``SequencePredictLast`` semantics)."""

    def forward(self, batch: Batch) -> Batch:
        out = _copy_batch(batch)
        vals = batch.features[self.target]
        mask = self._mask(batch)
        lengths = mask.sum(-1).clamp(min=1)
        last_idx = (lengths - 1).long()
        pos = torch.arange(vals.shape[1], device=vals.device)[None, :]
        input_mask = mask & (pos < last_idx[:, None])
        last_vals = vals.gather(1, last_idx[:, None])[:, 0]
        for name in self.seq_names:
            if name in out.sequences.masks:
                out.sequences.masks[name] = input_mask
                out.sequences.lengths[name] = input_mask.sum(-1)
        out.targets[self.target] = last_vals
        return out


class TabularMaskRandom(TabularSequenceTransform):
    """BERT-style MLM selection: each valid position is masked with
    ``masking_prob`` (at least one per row); targets are the original ids at
    masked positions, and the PREDICTION mask rides the batch so the head
    scores only masked slots (reference ``SequenceMaskRandom`` semantics)."""

    def __init__(self, schema: Schema, target: str, masking_prob: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__(schema, target)
        self.masking_prob = masking_prob
        self.generator = generator

    def forward(self, batch: Batch) -> Batch:
        out = _copy_batch(batch)
        vals = batch.features[self.target]
        mask = self._mask(batch)
        rand = torch.rand(vals.shape, generator=self.generator, device=vals.device)
        mlm = mask & (rand < self.masking_prob)
        # guarantee at least one masked position per non-empty row
        none_masked = (~mlm).all(-1) & mask.any(-1)
        if none_masked.any():
            first_valid = mask.float().argmax(-1)
            rows = torch.nonzero(none_masked, as_tuple=True)[0]
            mlm[rows, first_valid[rows]] = True
        out.targets[self.target] = vals
        out.sequences.masks["__mlm__" + self.target] = mlm
        return out


class TabularMaskLast(TabularSequenceTransform):
    """Mask exactly the last valid position (evaluation-style MLM; reference
    ``SequenceMaskLast``)."""

    def forward(self, batch: Batch) -> Batch:
        out = _copy_batch(batch)
        vals = batch.features[self.target]
        mask = self._mask(batch)
        lengths = mask.sum(-1).clamp(min=1)
        last_idx = (lengths - 1).long()
        mlm = torch.zeros_like(mask)
        mlm[torch.arange(mask.shape[0], device=mask.device), last_idx] = mask.any(-1)
        out.targets[self.target] = vals
        out.sequences.masks["__mlm__" + self.target] = mlm
        return out


# ---------------------------------------------------------------------------
# session model
# ---------------------------------------------------------------------------

class NextItemOutput(ModelOutput):
    """Tied-softmax next-item head: scores = hidden @ item_table.T. The loss
    target comes from the sequence transform (CE at prediction-mask positions
    for predict-next, at MLM positions for mask-random)."""

    def __init__(self, item_col: ColumnSchema, table: nn.Embedding):
        super().__init__(target=item_col.name, loss=nn.CrossEntropyLoss())
        self.table = [table]  # list: keep out of the module tree (tied, not owned)

    def forward(self, hidden: torch.Tensor, batch: Optional[Batch] = None):
        return hidden @ self.table[0].weight.T  # (B, L, C) or (B, C)

    def compute_loss(self, out: torch.Tensor, batch: Batch) -> torch.Tensor:
        tgt = batch.targets[self.target]
        if out.dim() == 2:  # (B, C): last/whole-session prediction
            return self.loss(out, tgt.long())
        mlm = batch.sequences.masks.get("__mlm__" + self.target)
        mask = mlm if mlm is not None else batch.sequences.masks[self.target].bool()
        if tgt.dim() == 1:
            tgt = tgt[:, None].expand(-1, out.shape[1])
        flat_out = out[mask]
        flat_tgt = tgt[mask]
        if flat_out.shape[0] == 0:
            return out.sum() * 0.0
        return self.loss(flat_out, flat_tgt.long())


class _SessionEncoder(nn.Module):
    """Item embeddings + learned positions → causal TransformerEncoder →
    (B, L, D) hidden states with the padding mask respected."""

    def __init__(self, item_col: ColumnSchema, d_model: int, n_head: int,
                 n_layer: int, max_len: int = 512, causal: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.item_col = item_col
        self.causal = causal
        self.emb = nn.Embedding(item_col.cardinality, d_model)
        self.pos = nn.Parameter(torch.randn(max_len, d_model, generator=generator) * 0.02)
        # learned [MASK] embedding: MLM positions must NOT see their own item
        # (without replacement the model copies the input and the loss
        # collapses to 0 without learning — the bug ReplaceMaskedEmbeddings
        # exists to prevent, reference tf/transforms/sequence.py:967)
        self.mask_emb = nn.Parameter(torch.randn(d_model, generator=generator) * 0.02)
        layer = nn.TransformerEncoderLayer(
            d_model, n_head, dim_feedforward=4 * d_model, dropout=0.0,
            batch_first=True, norm_first=True,
        )
        self.encoder = nn.TransformerEncoder(layer, n_layer)

    def forward(self, inputs: Dict[str, torch.Tensor], batch: Optional[Batch] = None):
        ids = inputs[self.item_col.name].long()
        B, L = ids.shape
        x = self.emb(ids)
        if batch is not None:
            mlm = batch.sequences.masks.get("__mlm__" + self.item_col.name)
            if mlm is not None:
                x = torch.where(mlm[:, :, None], self.mask_emb[None, None], x)
        x = x + self.pos[None, :L]
        pad = None
        if batch is not None and self.item_col.name in batch.sequences.masks:
            pad = ~batch.sequences.masks[self.item_col.name].bool()
            # fully-masked rows make attention NaN; keep one slot open (its
            # output is discarded by the loss mask anyway)
            allpad = pad.all(-1)
            if allpad.any():
                pad = pad.clone()
                pad[allpad, 0] = False
        attn = None
        if self.causal:
            attn = torch.triu(torch.ones(L, L, dtype=torch.bool, device=ids.device), diagonal=1)
        return self.encoder(x, mask=attn, src_key_padding_mask=pad)


class SessionTransformerModel(Model):
    """Torch session transformer with tied next-item softmax. Train with
    ``fit(..., pre=TabularPredictNext(...))`` (or the MLM transforms with
    ``causal=False``); ``encode`` batch-predicts one embedding per session
    (last valid hidden state) — the torch answer to the reference's
    ``torch/predict.py`` encoder sweep. The model lives on ``device``
    (default the card); ``generator`` (a CPU one) draws the initial
    positions and ``[MASK]`` embedding."""

    def __init__(self, schema: Schema, d_model: int = 64, n_head: int = 4,
                 n_layer: int = 2, causal: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        dev = resolve_device(device)
        item_col = schema.item_id_column
        enc = _SessionEncoder(item_col, d_model, n_head, n_layer, causal=causal,
                              generator=generator)
        head = NextItemOutput(item_col, enc.emb)
        super().__init__(enc, head, schema=schema, device=dev)
        self.item_col = item_col

    # -- training --------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 256,
            learning_rate: float = 1e-3, verbose: int = 0, pre=None, device=None):
        from ..data.loader import Loader

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(
            data, batch_size, shuffle=True, drop_last=True
        )
        opt = torch.optim.Adam(self.parameters(), lr=learning_rate)
        history = {"loss": []}
        self.train()
        head = self.blocks[1]
        for epoch in range(epochs):
            total, count = 0.0, 0
            for x, y in loader:
                batch = Batch.from_loader_batch(x, y, device=dev)
                if pre is not None:
                    batch = pre(batch)
                hidden = self.blocks[0](batch.features, batch=batch)
                out = head(hidden, batch=batch)
                loss = head.compute_loss(out, batch)
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

    # -- batch prediction -------------------------------------------------
    def encode(self, data, batch_size: int = 1024, device=None) -> np.ndarray:
        """One embedding per session: the hidden state at the last valid
        position (batch sweep, valid rows only)."""
        from ..data.loader import ROW_VALID_KEY, Loader

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        self.eval()
        chunks: List[np.ndarray] = []
        with torch.no_grad():
            for x, _ in loader:
                batch = Batch.from_loader_batch(x, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                hidden = self.blocks[0](batch.features, batch=batch)
                mask = batch.sequences.masks[self.item_col.name].bool()
                last = (mask.sum(-1).clamp(min=1) - 1).long()
                emb = hidden[torch.arange(hidden.shape[0], device=dev), last]
                e = emb.cpu().numpy()
                chunks.append(e[valid] if valid is not None else e)
        return np.concatenate(chunks, axis=0)

    def predict_next(self, data, k: int = 10, batch_size: int = 1024, device=None):
        """Top-k next items per session from the tied softmax."""
        from ..data.loader import ROW_VALID_KEY, Loader

        dev = check_module_device(self, device)
        loader = data if isinstance(data, Loader) else Loader(data, batch_size)
        self.eval()
        scores_l, ids_l = [], []
        head = self.blocks[1]
        with torch.no_grad():
            for x, _ in loader:
                batch = Batch.from_loader_batch(x, device=dev)
                valid = np.asarray(x[ROW_VALID_KEY]) if ROW_VALID_KEY in x else None
                hidden = self.blocks[0](batch.features, batch=batch)
                mask = batch.sequences.masks[self.item_col.name].bool()
                last = (mask.sum(-1).clamp(min=1) - 1).long()
                emb = hidden[torch.arange(hidden.shape[0], device=dev), last]
                logits = head(emb)
                s, i = torch.topk(logits, min(k, logits.shape[-1]), dim=-1)
                s, i = s.cpu().numpy(), i.cpu().numpy()
                if valid is not None:
                    s, i = s[valid], i[valid]
                scores_l.append(s)
                ids_l.append(i)
        return np.concatenate(scores_l), np.concatenate(ids_l)
