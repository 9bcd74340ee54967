"""Model: a sequential container ending in a head, with ``predict``
(the serving subset of ``models_tpu/models/base.py``)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from torch import nn

from ..core.block import Block
from ..core.device import check_module_device
from ..core.types import ModelContext, Prediction, TopKPrediction, to_device_batch
from ..data.dataset import Dataset
from ..data.loader import ROW_VALID_KEY, Loader


class Model(Block):
    def __init__(self, *blocks: nn.Module):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        for b in blocks:
            if getattr(b, "schema", None) is not None:
                self.schema = b.schema
                break

    def forward(self, inputs, **kwargs):
        kwargs.setdefault("context", ModelContext(features=inputs))
        out = inputs
        for block in self.blocks:
            out = block(out, **kwargs)
        return out

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
