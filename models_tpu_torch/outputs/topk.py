"""Top-k retrieval layers (``models_tpu/outputs/topk.py``, fp32 and bf16
indexes on one device)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.block import Block
from ..core.device import resolve_device
from ..core.types import TopKPrediction
from ..ops.topk import _BINNED_BIN_SIZE, topk_scores


class BruteForce(Block):
    """Exact top-k over the whole candidate matrix.

    :meth:`index` zero-pads the matrix ONCE to a multiple of the 64-row bin
    (padded ids are -1) and keeps the real row count in ``n_valid``, so the
    binned route masks the padding in its small pool instead of copying the
    matrix on every request."""

    def __init__(self, k: int = 10):
        super().__init__()
        self.k = int(k)
        self.n_valid: Optional[int] = None
        self.register_buffer("candidates", None)
        self.register_buffer("ids", None)

    def index(self, candidates, ids=None, dtype: torch.dtype = torch.float32,
              device=None) -> "BruteForce":
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"index dtype must be float32 or bfloat16, not {dtype} "
                             "(the int8 index is not ported yet)")
        dev = resolve_device(device)
        cand = torch.as_tensor(candidates, device=dev).to(torch.float32)
        n = cand.shape[0]
        ids = (torch.arange(n, dtype=torch.int32, device=dev) if ids is None
               else torch.as_tensor(ids, device=dev).to(torch.int32))
        pad = (-n) % _BINNED_BIN_SIZE
        if pad:
            cand = torch.cat([cand, cand.new_zeros(pad, cand.shape[1])])
            ids = torch.cat([ids, ids.new_full((pad,), -1)])
        self.candidates = cand.to(dtype).contiguous()
        self.ids = ids.contiguous()
        self.n_valid = int(n)
        return self

    def index_from_dataset(self, dataset, dtype: torch.dtype = torch.float32,
                           device=None) -> "BruteForce":
        """Index a Dataset with columns ``id`` and ``embedding`` (n, D)."""
        data = dataset.to_numpy_dict()
        ids = np.asarray(data["id"])
        if len(np.unique(ids)) != len(ids):
            raise ValueError("Candidate ids must be unique to build a top-k index")
        return self.index(np.asarray(data["embedding"]), ids, dtype=dtype, device=device)

    def forward(self, queries, k: Optional[int] = None, **kwargs) -> TopKPrediction:
        if self.candidates is None:
            raise ValueError("BruteForce index is empty; call index() first")
        scores, ids = topk_scores(
            queries, self.candidates, k or self.k, ids=self.ids, n_valid=self.n_valid,
            device=self.candidates.device,
        )
        return TopKPrediction(scores, ids)


class TopKOutput(Block):
    """Head wrapping a :class:`BruteForce` layer: a serving request in, a
    :class:`TopKPrediction` out (the inference branch of the JAX head)."""

    def __init__(self, k: int = 10, candidates=None, item_id_name: Optional[str] = None,
                 candidate_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(block_name="topk_output")
        self.k = int(k)
        self.item_id_name = item_id_name
        self.topk_layer = BruteForce(k=k)
        dtype = torch.float32 if candidate_dtype is None else candidate_dtype
        if candidates is not None:
            self.topk_layer.index_from_dataset(candidates, dtype=dtype, device=device)

    def forward(self, inputs, **kwargs) -> TopKPrediction:
        queries = inputs["query"] if isinstance(inputs, dict) else inputs
        return self.topk_layer(queries, k=self.k)
