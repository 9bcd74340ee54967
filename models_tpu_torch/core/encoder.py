"""Encoders: offline embedding sweeps and top-k serving
(``models_tpu/core/encoder.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader
from ..schema import Tags
from .block import Block
from .device import check_module_device
from .types import ModelContext, to_device_batch


class Encoder(Block):
    """Wrap a block for batch inference."""

    def __init__(self, block: Block):
        super().__init__(schema=getattr(block, "schema", None))
        self.block = block

    def forward(self, inputs, **kwargs):
        return self.block(inputs, **kwargs)

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


def TopKEncoder(
    query_encoder: Block,
    candidates=None,
    k: int = 10,
    item_id_name: Optional[str] = None,
    candidate_dtype: Optional[torch.dtype] = None,
    device=None,
):
    """Query encoder + brute-force top-k head, as a model whose ``predict``
    serves ``{"scores", "ids"}``."""
    from ..models.base import Model
    from ..outputs.topk import TopKOutput

    output = TopKOutput(k=k, candidates=candidates, item_id_name=item_id_name,
                        candidate_dtype=candidate_dtype, device=device)
    model = Model(query_encoder, output)
    model.block_name = "topk_encoder"
    return model
