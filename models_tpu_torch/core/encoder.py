"""Encoders: offline embedding sweeps and top-k serving
(``models_tpu/core/encoder.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader
from ..schema import Schema, Tags
from .block import Block
from .device import check_module_device
from .types import ModelContext, to_device_batch


class Encoder(Block):
    """Blocks (one, or several in sequence) for batch inference; ``schema``
    defaults to the block's. It does not train: ``fit`` raises."""

    def __init__(self, *blocks, schema: Optional[Schema] = None):
        from .combinators import SequentialBlock

        block = blocks[0] if len(blocks) == 1 else SequentialBlock(list(blocks))
        super().__init__(schema=schema if schema is not None else getattr(block, "schema", None))
        self.block = block

    def forward(self, inputs, **kwargs):
        return self.block(inputs, **kwargs)

    def fit(self, *args, **kwargs):
        raise RuntimeError("Encoder is inference-only; train the parent model instead")

    def batch_predict(self, dataset: Dataset, batch_size: int = 1024, device=None) -> Dataset:
        """:meth:`encode` without an index column: ``id`` the row numbers."""
        return self.encode(dataset, batch_size=batch_size, device=device)

    @torch.no_grad()
    def encode(
        self,
        dataset: Dataset,
        index: Optional[Union[str, Tags]] = None,
        batch_size: int = 1024,
        device=None,
    ) -> Dataset:
        """Sweep the dataset through the block in batches; return a Dataset of
        ``id`` (the index column, or row numbers) and ``embedding`` (n, D),
        valid rows only."""
        dev = check_module_device(self, device)
        loader = Loader(dataset, batch_size)
        index_name = None
        if isinstance(index, Tags) or index in [t.value for t in Tags]:
            sel = loader.schema.select_by_tag(index)
            index_name = sel.first.name if len(sel) else None
        elif index is not None:
            index_name = str(index)
        ids, chunks = [], []
        for x, _ in loader:
            xb = to_device_batch(x, dev)
            out = self(xb, context=ModelContext(features=xb))
            valid = x[ROW_VALID_KEY]
            chunks.append(out.cpu().numpy()[valid])
            if index_name is not None:
                ids.append(np.asarray(x[index_name])[valid])
        emb = np.concatenate(chunks, axis=0)
        return Dataset({
            "id": np.concatenate(ids) if index_name is not None else np.arange(len(emb)),
            "embedding": emb,
        })


class EmbeddingEncoder(Encoder):
    """One embedding table as an encoder (the matrix factorization's query
    tower): the rows of its feature, looked up from a batch dict (the
    feature, or any column the table serves) or from ids. The context goes
    on to the table, whose row-sparse route records the lookup there (the
    JAX package's note: dropping it froze the query table of
    ``MatrixFactorizationModel`` under an ``embedding_optimizer``)."""

    def __init__(self, table, feature_name: Optional[str] = None):
        from ..inputs.embedding import EmbeddingTable

        if not isinstance(table, EmbeddingTable):
            raise TypeError(f"EmbeddingEncoder takes an EmbeddingTable, not "
                            f"{type(table).__name__}")
        super().__init__(table)
        self.schema = table.schema
        self.table = table
        self.feature_name = feature_name or table.features[0]

    def forward(self, inputs, context=None, **kwargs):
        feature = self.feature_name
        if isinstance(inputs, dict):
            val = inputs.get(feature)
            if val is None:
                for f in self.table.features:
                    if f in inputs:
                        val, feature = inputs[f], f
                        break
            if val is None:
                raise KeyError(f"{self.feature_name} not found in inputs")
            return self.table._call_single(val, context, feature)
        return self.table._call_single(inputs, context, feature)

    def to_dataset(self) -> Dataset:
        return self.table.to_dataset()


def TopKEncoder(
    query_encoder: Block,
    candidates=None,
    k: int = 10,
    topk_layer: Union[str, Block] = "brute-force-topk",
    item_id_name: Optional[str] = None,
    candidate_dtype: Optional[torch.dtype] = None,
    device=None,
    mesh=None,
):
    """Query encoder + brute-force top-k head, as a model whose ``predict``
    serves ``{"scores", "ids"}``. ``topk_layer``: ``"brute-force-topk"`` or
    a :class:`~models_tpu_torch.outputs.topk.BruteForce` (``method=`` forces
    a route); anything else raises. ``mesh`` splits the index by rows over
    the mesh's model axis: every rank of a model line then serves the same
    queries."""
    from ..models.base import Model
    from ..outputs.topk import TopKOutput

    output = TopKOutput(k=k, candidates=candidates, item_id_name=item_id_name,
                        candidate_dtype=candidate_dtype, to_call=topk_layer, device=device,
                        mesh=mesh)
    model = Model(query_encoder, output)
    model.block_name = "topk_encoder"
    return model
