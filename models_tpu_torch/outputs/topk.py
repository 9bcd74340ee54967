"""Top-k retrieval layers (``models_tpu/outputs/topk.py``): the
:class:`TopKLayer` base and its brute-force index (fp32, bf16 and
bin-quantized int8, on one device or split by rows over a mesh's model
axis), and the top-k head with its evaluation branch."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.block import Block
from ..core.config import set_init_arg
from ..core.device import resolve_device
from ..core.types import Prediction, TopKPrediction
from ..ops.topk import _BINNED_BIN_SIZE, int8_scale, sharded_topk, topk_scores
from ..registry import topk_registry
from .base import ModelOutput

INDEX_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


class TopKLayer(Block):
    """A top-k layer: :meth:`index` the candidates, then call it on queries
    for a :class:`TopKPrediction`."""

    def __init__(self, k: int = 10):
        super().__init__()
        self.k = int(k)

    def index(self, candidates, ids=None, dtype: torch.dtype = torch.float32,
              device=None, mesh=None) -> "TopKLayer":
        raise NotImplementedError

    def index_from_dataset(self, dataset, check_unique_ids: bool = True,
                           dtype: torch.dtype = torch.float32, device=None,
                           mesh=None) -> "TopKLayer":
        """Index a Dataset (or a dict of arrays) of ``id`` (else its first
        column) and ``embedding`` (n, D), or ``embedding__values`` (flat), or
        else one vector column per dimension (every column but the ids)."""
        data = dataset.to_numpy_dict() if hasattr(dataset, "to_numpy_dict") else dataset
        id_col = "id" if "id" in data else next(iter(data))
        ids = np.asarray(data[id_col])
        if "embedding__values" in data:
            emb = np.asarray(data["embedding__values"]).reshape(len(ids), -1)
        elif "embedding" in data:
            emb = data["embedding"]
            emb = np.asarray(emb) if getattr(emb, "ndim", 1) == 2 else np.asarray(list(emb))
        else:
            emb = np.stack([np.asarray(data[c]) for c in data if c != id_col], axis=1)
        if check_unique_ids:
            self._check_unique_ids(ids)
        return self.index(emb, ids, dtype=dtype, device=device, mesh=mesh)

    @staticmethod
    def _check_unique_ids(ids) -> None:
        arr = np.asarray(ids)
        if len(np.unique(arr)) != len(arr):
            raise ValueError("Candidate ids must be unique to build a top-k index")


@topk_registry.register("brute-force-topk")
class BruteForce(TopKLayer):
    """Exact top-k over the whole candidate matrix.

    :meth:`index` zero-pads the matrix ONCE to a multiple of the 64-row bin
    (padded ids are -1) and keeps the real row count in ``n_valid``, so the
    binned route masks the padding in its small pool instead of copying the
    matrix on every request. The index (``candidates``, ``ids``,
    ``scales``) and its count of padded rows (``padding``) are buffers: a
    saved model, a checkpoint and an exported program hold them.
    ``method`` forces a route of ``ops/topk.py::topk_route`` (``"auto"``
    picks by shape).

    With a mesh (``index(mesh=)``, or ``mesh`` set before it) whose model
    axis divides the row count, each rank keeps its contiguous shard of the
    index, unpadded, and a query runs :func:`~models_tpu_torch.ops.topk.
    sharded_topk` over its model line: only (B, k) lists move."""

    def __init__(self, k: int = 10, method: str = "auto"):
        super().__init__(k)
        self.method = method
        self.n_valid: Optional[int] = None
        self.scales_per_bin = False
        self.mesh = None
        self.register_buffer("candidates", None)
        self.register_buffer("ids", None)
        self.register_buffer("scales", None)
        self.register_buffer("padding", None)

    def state_loaded(self) -> None:
        """Read the row count back from the buffers after a load."""
        if self.candidates is not None and self.padding is not None:
            self.n_valid = int(self.candidates.shape[0] - int(self.padding))
            self.scales_per_bin = self.scales is not None

    @staticmethod
    def _mesh_fits(mesh, n_candidates: int) -> bool:
        from ..parallel.mesh import MODEL_AXIS

        n = mesh.size(MODEL_AXIS)
        return n > 1 and n_candidates % n == 0

    def index(self, candidates, ids=None, dtype: torch.dtype = torch.float32,
              device=None, mesh=None) -> "BruteForce":
        """Store ``candidates`` (n, D) with their ``ids`` (default 0..n-1) as
        ``dtype``: float32, bfloat16, or int8, bin-quantized as the JAX
        package quantizes it. The int8 index sorts the rows by their largest
        |element| (a stable sort, so equal rows keep their order), carries
        the ids along, zero-pads to whole bins, and stores one scale per
        64-row bin, ``max|row| / 127`` over the bin (1/127 for an all-zero
        bin), with each row ``round(row / scale)`` clipped to +-127. Neighbours
        in the sort have similar norms, so a bin's scale fits each of its
        rows within a few percent; ``scales`` keeps the scale of every row
        and ``scales_per_bin`` says it is constant within each bin.

        On a mesh (the class's note) the int8 index keeps its bins where each
        shard is a whole number of them (``n % (n_shards * 64) == 0``), else
        it takes one scale a row, unsorted, as the JAX package's does."""
        if dtype not in INDEX_DTYPES:
            raise ValueError(f"index dtype must be float32, bfloat16 or int8, not {dtype}")
        from ..parallel.mesh import MODEL_AXIS

        dev = resolve_device(device)
        cand = torch.as_tensor(candidates, device=dev).to(torch.float32)
        n = cand.shape[0]
        ids = (torch.arange(n, dtype=torch.int32, device=dev) if ids is None
               else torch.as_tensor(ids, device=dev).to(torch.int32))
        mesh = mesh if mesh is not None else self.mesh
        use_mesh = mesh is not None and self._mesh_fits(mesh, n)
        n_shards = mesh.size(MODEL_AXIS) if use_mesh else 1
        pad = 0 if use_mesh else (-n) % _BINNED_BIN_SIZE
        scales = None
        per_row = use_mesh and n % (n_shards * _BINNED_BIN_SIZE) != 0
        if dtype == torch.int8 and per_row:
            scales = int8_scale(cand.abs().amax(dim=1))
        elif dtype == torch.int8:
            amax = cand.abs().amax(dim=1)
            order = torch.argsort(amax, stable=True)
            cand, ids, amax = cand[order], ids[order], amax[order]
            if pad:
                amax = torch.cat([amax, amax.new_zeros(pad)])
            bin_scale = int8_scale(amax.view(-1, _BINNED_BIN_SIZE).amax(dim=1))
            scales = bin_scale.repeat_interleave(_BINNED_BIN_SIZE)
        if pad:
            cand = torch.cat([cand, cand.new_zeros(pad, cand.shape[1])])
            ids = torch.cat([ids, ids.new_full((pad,), -1)])
        if scales is not None:
            cand = torch.clamp(torch.round(cand / scales[:, None]), -127, 127)
        cand = cand.to(dtype)
        self.scales_per_bin = scales is not None and not per_row
        self.n_valid = int(n)
        if use_mesh:
            # this rank's contiguous rows; the state records them as a shard
            rows = n // n_shards
            part = slice(mesh.index(MODEL_AXIS) * rows, (mesh.index(MODEL_AXIS) + 1) * rows)
            cand, ids = cand[part], ids[part]
            scales = scales[part] if scales is not None else None
            self.__dict__["_mesh_specs"] = {
                name: (MODEL_AXIS,) + (None,) * (name == "candidates")
                for name in ("candidates", "ids") + (("scales",) if scales is not None else ())}
            self.__dict__["_mesh_of_state"] = mesh
            self.mesh = mesh
        else:
            self.__dict__.pop("_mesh_specs", None)
            self.mesh = None
        self.candidates = cand.contiguous()
        self.ids = ids.contiguous()
        self.scales = scales.contiguous() if scales is not None else None
        self.padding = torch.tensor(pad, dtype=torch.int64, device=dev)
        return self

    def forward(self, queries, k: Optional[int] = None, **kwargs) -> TopKPrediction:
        if self.candidates is None:
            raise ValueError("BruteForce index is empty; call index() first")
        if self.mesh is not None and self.__dict__.get("_mesh_specs"):
            scores, ids = sharded_topk(
                torch.as_tensor(queries, device=self.candidates.device), self.candidates,
                k or self.k, self.mesh, ids=self.ids, col_scale=self.scales,
                col_scale_per_bin=self.scales_per_bin)
            return TopKPrediction(scores, ids)
        scores, ids = topk_scores(
            queries, self.candidates, k or self.k, ids=self.ids, n_valid=self.n_valid,
            col_scale=self.scales, col_scale_per_bin=self.scales_per_bin, method=self.method,
            device=self.candidates.device,
        )
        return TopKPrediction(scores, ids)

    def score_all(self, queries) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full (B, n) score matrix and the ids of its columns, padding
        dropped: fp32 queries against the rows widened to fp32, times each
        row's scale (int8). Not on a mesh-split index."""
        if self.__dict__.get("_mesh_specs"):
            raise NotImplementedError("score_all holds the (B, n) scores of the whole catalog: "
                                      "not on an index split over a mesh")
        cand, ids, scales = self.candidates, self.ids, self.scales
        if self.n_valid is not None and self.n_valid < cand.shape[0]:
            cand, ids = cand[: self.n_valid], ids[: self.n_valid]
            scales = scales[: self.n_valid] if scales is not None else None
        scores = torch.as_tensor(queries, device=cand.device).to(torch.float32) \
            @ cand.to(torch.float32).T
        if scales is not None:
            scores = scores * scales[None, :]
        return scores, ids


class TopKOutput(ModelOutput):
    """Head wrapping a :class:`BruteForce` layer. A serving request gives a
    :class:`TopKPrediction`. With targets, or under the engine's ``testing``
    flag, the head evaluates: the relevance of each returned id (is it the
    row's true item?) with ``label_relevant_counts`` 1 per row, for the top-k
    metrics. ``mesh`` splits the index over the mesh's model axis (the
    layer's note)."""

    default_loss = None  # retrieval evaluation has no trainable loss

    def __init__(self, k: int = 10, candidates=None, item_id_name: Optional[str] = None,
                 default_metrics_top_ks=(10,), candidate_dtype: Optional[torch.dtype] = None,
                 to_call: Union[str, "BruteForce", None] = "brute-force-topk", device=None,
                 mesh=None):
        super().__init__(target=item_id_name)
        self.block_name = "topk_output"
        self.k = int(k)
        self.item_id_name = item_id_name
        self.top_ks = tuple(default_metrics_top_ks)
        # to_call: a top-k layer's registered name or the layer
        if to_call is None or isinstance(to_call, str):
            to_call = topk_registry.parse(to_call or "brute-force-topk", k=k)
        if not isinstance(to_call, BruteForce):
            raise ValueError(f"the top-k layer must be 'brute-force-topk' or a BruteForce, not "
                             f"{to_call!r}")
        self.topk_layer = to_call
        if mesh is not None:
            self.topk_layer.mesh = mesh
        # a mesh is no constructor argument a saved config can replay
        set_init_arg(self, "mesh", None)
        dtype = torch.float32 if candidate_dtype is None else candidate_dtype
        if candidates is not None:
            self.topk_layer.index_from_dataset(candidates, dtype=dtype, device=device)
            # the index is the layer's state: a saved config replays an empty one
            set_init_arg(self, "candidates", None)

    def default_metrics(self):
        from ..metrics.topk import TopKMetricsAggregator

        return [TopKMetricsAggregator.default(min(k, self.k)) for k in self.top_ks]

    def forward(self, inputs, *, context=None, targets=None, **kwargs):
        queries = inputs["query"] if isinstance(inputs, dict) else inputs
        topk = self.topk_layer(queries, k=self.k)
        testing = bool(context.get("testing", False)) if context is not None else False
        true_ids = None
        if targets is not None and not isinstance(targets, dict):
            true_ids = targets
        elif isinstance(targets, dict) and self.item_id_name in targets:
            true_ids = targets[self.item_id_name]
        elif testing and context is not None and self.item_id_name is not None:
            true_ids = context.features.get(self.item_id_name)
        if true_ids is None:
            return topk  # a serving request
        rel = (topk.identifiers == true_ids.reshape(-1, 1)).to(torch.float32)
        return Prediction(outputs=topk.scores, targets=rel,
                          label_relevant_counts=torch.ones(rel.shape[0], device=rel.device))
