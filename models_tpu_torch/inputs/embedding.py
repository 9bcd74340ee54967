"""Embedding tables and the schema-driven ``Embeddings()`` factory
(``models_tpu/inputs/embedding.py``, the plain single-device lookup), with
the fused tables of the ranking models.

Columns sharing an int-domain name share one table. A list column not tagged
``SEQUENCE`` is pooled over its mask (``sequence_combiner``: mean by
default, or sum). Tables are float32 or, at rest, bfloat16; lookups of a
bf16 table are cast to the policy's compute dtype (float32, or bf16 under
``mixed_bfloat16``: ``_cast_up``).

``Embeddings(fused=True)`` (the DLRM's default) puts the single-column
scalar domains into uniform-stride :class:`FusedEmbeddingTables`, grouped by
:func:`_fused_groups` with the JAX package's constants (so the grouping, and
so the parameters, are the same function of the schema in both packages):
one lookup of (B, F) offset ids instead of F. The JAX package takes the
fused table's gradient as a one-hot product, a workaround for XLA's slow
scatter on TPU; the port keeps the function, ``F.embedding`` on the offset
ids, whose backward sums the repeated rows.

A table routed to the row-sparse optimizer (``sparse_routed``, set by
``Model.fit``) looks up from the detached table, in training, into float32
rows that are a leaf of the autograd graph: after the backward their
``.grad`` is the gradient of the gathered rows, whatever the table's dtype.
Each such lookup is recorded as ``(table, ids, rows, key)`` in the context's
``sparse_lookups``; a sequence column is recorded before its combiner, with
the padded (B, L) ids, as the JAX package taps it, and a fused table with
its (B, F) offset ids. ``key`` names the lookup's site as the JAX package
keys its taps: the column's name, ``"pos"`` and ``"neg"`` for a tied
head's positives and sampled negatives, ``""`` for a fused table.

``l2_reg`` adds ``l2_reg * sum(table**2)`` (padding rows included) to the
training loss (:meth:`EmbeddingTable.regularization_loss`); a row-sparse
table's term is a constant, as the JAX package's sparse step takes no
gradient of it.

On a mesh (``fit(mesh=)``, ``parallel/mesh.py``) a table whose padded rows
divide the model axis is split by rows over it, as the JAX package places
it: the table records its ``shard`` and looks its rows up through
``ops/embedding_lookup.py::sharded_lookup`` (the all-to-all route, K9 at the
owner), with no lookup that reads a shard as if it were the table. Under a
mesh step (the context's ``mesh``) the lookup's backward gives the shard the
global batch's gradient; a row-sparse table's lookup records the rows it
got, whose gradients the engine gathers over the data axis. A sharded
table's ``l2_reg`` term sums every shard's rows.

A table made with ``trainable=False`` holds its rows in a buffer, not a
parameter (the JAX package's ``nnx.Variable``): no optimizer, dense or
row-sparse, sees it. ``weights=`` (or :meth:`EmbeddingTable.from_pretrained`)
starts a table from given rows. ``Embeddings`` also makes tensor-train
tables (``tt_compression_threshold``; ``inputs/tt_embedding.py``) and
dynamic-vocabulary tables (``dynamic``; ``inputs/dynamic.py``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.aggregation import SEQUENCE_COMBINERS
from ..core.combinators import ParallelBlock
from ..core.policy import compute_dtype
from ..core.block import Block
from ..core.config import set_init_arg
from ..core.device import resolve_device
from ..core.types import SequenceFeature, TensorDict
from ..schema import (ColumnSchema, Schema, Tags, create_categorical_column,
                      infer_embedding_dim)


class SparseSlots(nn.Module):
    """The row-sparse optimizer's per-row state of one table (``acc``, or
    ``m`` and ``v``; none for sgd), float32 buffers of the table's shape.
    They move and copy with the model and outlive ``fit`` and ``compile``."""

    def __init__(self, slots: Dict[str, torch.Tensor]):
        super().__init__()
        for name, value in slots.items():
            self.register_buffer(name, value)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._buffers[name]

    def keys(self):
        return list(self._buffers)


class EmbeddingTable(Block):
    """One table, serving one or more columns of its domain.

    Rows are padded to a multiple of 8, as in the JAX package, so that its
    tables load whole; ids must stay below ``input_dim`` (a CUDA gather out
    of range is a device-side assert, where ``jnp.take`` would not fault).
    Without ``device`` the table is made on the card, and raises without one.
    """

    def __init__(
        self,
        dim: int,
        col_schema: Union[ColumnSchema, Sequence[ColumnSchema]],
        sequence_combiner: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        device=None,
        l2_reg: float = 0.0,
        trainable: bool = True,
        initializer: Optional[Callable] = None,
        weights=None,
    ):
        cols = [col_schema] if isinstance(col_schema, ColumnSchema) else list(col_schema)
        super().__init__(schema=Schema(cols), block_name=cols[0].domain_name)
        self.dim = int(dim)
        self.l2_reg = float(l2_reg)
        self.trainable = bool(trainable)
        self.features = [c.name for c in cols]
        self.sequence_combiner = sequence_combiner
        card = cols[0].cardinality
        if card is None:
            raise ValueError(f"Column {cols[0].name} has no cardinality; cannot embed")
        if any(c.cardinality != card for c in cols[1:]):
            raise ValueError("Features sharing an embedding table must share its domain")
        self.input_dim = int(card)
        self.padded_rows = -(-self.input_dim // 8) * 8
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"embedding tables are float32 or bfloat16, not {dtype}")
        device = resolve_device(device)
        if weights is not None:
            w = torch.as_tensor(np.asarray(weights), dtype=torch.float32)
            if tuple(w.shape) != (self.input_dim, self.dim):
                raise ValueError(f"Pretrained weights {tuple(w.shape)} != "
                                 f"({self.input_dim}, {self.dim})")
            table = torch.zeros(self.padded_rows, self.dim, device=device)
            table[: self.input_dim] = w.to(table.device)
            # the rows are the table's state: the config keeps no copy
            set_init_arg(self, "weights", None)
        elif initializer is not None:
            # a function (generator, shape, device) -> rows
            gen = torch.Generator(device).manual_seed(seed)
            table = initializer(gen, (self.padded_rows, self.dim), device)
        else:
            table = torch.empty(self.padded_rows, self.dim, device=device)
            gen = torch.Generator(table.device).manual_seed(seed)
            # truncated normal at 2 sigma, sigma 0.05 (the JAX initializer)
            nn.init.trunc_normal_(table, std=0.05, a=-0.1, b=0.1, generator=gen)
        # trained densely, the lookup's backward gives a (rows, D) gradient,
        # as the JAX package's dense optimizer sees it; not trainable, the
        # rows are a buffer
        if self.trainable:
            self.table = nn.Parameter(table.to(dtype))
        else:
            self.register_buffer("table", table.to(dtype))
        self.sparse_routed = False
        # the row-sparse optimizer's per-row state, created by its init_slots
        self.sparse_slots: Optional[SparseSlots] = None
        # this rank's rows of a table split over a mesh (parallel/mesh.py)
        self.shard = None

    @classmethod
    def from_pretrained(cls, data, col_schema: Optional[ColumnSchema] = None,
                        trainable: bool = True, name: str = "pretrained",
                        sequence_combiner: Optional[str] = None, device=None
                        ) -> "EmbeddingTable":
        """A table of a (cardinality, dim) array's rows (a column named
        ``name`` of that cardinality where none is given)."""
        arr = np.asarray(data)
        if col_schema is None:
            col_schema = create_categorical_column(name, arr.shape[0] - 1)
        return cls(arr.shape[1], col_schema, sequence_combiner=sequence_combiner,
                   trainable=trainable, weights=arr, device=device)

    @property
    def embeddings(self) -> torch.Tensor:
        return self.table[: self.input_dim]

    def to_array(self) -> np.ndarray:
        """The ``input_dim`` rows on the host (a bf16 table's widened); a
        table split over a mesh gathers its shards (every rank of the model
        line calls it)."""
        if self.shard is not None:
            from ..parallel.mesh import gather_full

            full = gather_full(self.table, (self.shard.axis, None), self.shard.mesh)
            return full[: self.input_dim].float().cpu().numpy()
        return self.embeddings.detach().float().cpu().numpy()

    def to_dataset(self):
        """The table's ``input_dim`` rows as a Dataset of ``id`` (int64) and
        ``embedding`` (float32; a bf16 table's rows widened)."""
        from ..data.dataset import Dataset

        emb = self.to_array()
        return Dataset({"id": np.arange(emb.shape[0], dtype=np.int64), "embedding": emb})

    def regularization_loss(self) -> Optional[torch.Tensor]:
        """``l2_reg * sum(table**2)``, or None without a regularizer."""
        if not self.l2_reg:
            return None
        table = self.table.detach() if self.sparse_routed else self.table
        term = self.l2_reg * table.float().square().sum()
        if self.shard is not None:
            # the value sums every shard; the gradient is this shard's own
            from ..parallel.collectives import all_reduce

            whole = all_reduce(term.detach().clone(), self.shard.mesh.group(self.shard.axis))
            term = term + (whole - term.detach())
        return term

    def _lookup(self, ids, context, key: str = ""):
        lookups = context.get("sparse_lookups") if context is not None else None
        if self.shard is not None:
            return self._sharded_lookup(ids, context, lookups, key)
        if lookups is not None and self.sparse_routed:
            rows = F.embedding(ids.long(), self.table.detach()).float().requires_grad_()
            lookups.append((self, ids, rows, key))
            return rows
        # F.embedding, not table[ids]: its backward sums repeated ids by
        # sorting them, where the indexing backward serialises each repeated
        # row (genres: 21 rows take every list entry of a batch)
        return self._cast_up(F.embedding(ids.long(), self.table))

    def _sharded_lookup(self, ids, context, lookups, key: str):
        """The lookup of a table split over a mesh (the module's note)."""
        from ..ops.embedding_lookup import sharded_lookup
        from ..parallel.mesh import DATA_AXIS

        shard = self.shard
        in_step = context is not None and context.get("mesh") is not None
        if lookups is not None and self.sparse_routed:
            with torch.no_grad():
                rows = sharded_lookup(self.table.detach(), ids, shard.mesh, axis=shard.axis)
            rows = rows.float().requires_grad_()
            lookups.append((self, ids, rows, key))
            return rows
        return self._cast_up(sharded_lookup(self.table, ids, shard.mesh, axis=shard.axis,
                                            data_axis=DATA_AXIS if in_step else None))

    @staticmethod
    def _cast_up(emb: torch.Tensor) -> torch.Tensor:
        """Rows of a bf16 table in the policy's compute dtype; float32 rows
        as they are. (The row-sparse lookup's rows are float32 leaves: the
        JAX package's float32 tap, added to them, makes them float32 too.)"""
        return emb if emb.dtype == torch.float32 else emb.to(compute_dtype())

    def _call_single(self, value, context, feature: Optional[str] = None):
        key = feature or self.features[0]
        if isinstance(value, SequenceFeature):
            emb = self._lookup(value.values, context, key)  # (B, L, D)
            seq = SequenceFeature(emb, value.mask)
            if self.sequence_combiner is None:
                return seq
            return SEQUENCE_COMBINERS[self.sequence_combiner](seq)
        return self._lookup(value, context, key)

    def forward(self, inputs, context=None, **kwargs):
        if isinstance(inputs, dict):
            return {n: self._call_single(inputs[n], context, n)
                    for n in self.features if n in inputs}
        return self._call_single(inputs, context)

    def extra_repr(self) -> str:
        return f"{self.input_dim}x{self.dim}, features={self.features}"


# uniform-stride fused tables are worth their padding up to a point
_FUSED_STRIDE_MAX = 8192
_FUSED_BYTES_MAX = 256 << 20
# the JAX package's cost model of a fused group (its constants, taken
# unchanged so that both packages group a schema alike): a lookup's fixed
# cost, and the cost of a (feature x stride-row) of the backward; a stride
# tier merges into the next larger one when the extra rows cost less than
# the lookup it saves. Whether the card wants other groups is open
# (ROADMAP.md queue 2).
_FUSED_KERNEL_MS = 0.05
_FUSED_ROW_MS = 1.05e-5


def _fused_groups(cols: Sequence[ColumnSchema], dim: int) -> List[List[ColumnSchema]]:
    """Partition fusable columns into uniform-stride groups: power-of-two
    stride tiers merged upward where the cost model says so, each group at
    most ``_FUSED_STRIDE_MAX`` rows a column and ``_FUSED_BYTES_MAX`` in all.
    Columns of more padded rows than the stride cap, and tiers that leave
    fewer than two columns, stay out (they get their own tables)."""
    tiers: Dict[int, list] = {}
    for c in cols:
        p = -(-int(c.cardinality) // 8) * 8
        if p > _FUSED_STRIDE_MAX:
            continue
        tiers.setdefault(1 << (p - 1).bit_length(), []).append(c)
    strides = sorted(tiers)
    groups = []
    for i, s in enumerate(strides):
        group = tiers[s]
        if i + 1 < len(strides):
            # a lone column left behind costs a table of its own, so it
            # accepts a pricier merge than a tier that would fuse anyway
            thresh = _FUSED_KERNEL_MS if len(group) > 1 else 2 * _FUSED_KERNEL_MS
            if len(group) * (strides[i + 1] - s) * _FUSED_ROW_MS < thresh:
                tiers[strides[i + 1]] = group + tiers[strides[i + 1]]
                continue
        if len(group) < 2:
            continue
        max_feats = _FUSED_BYTES_MAX // (s * dim * 4)
        if max_feats < 2:
            continue
        for j in range(0, len(group), max_feats):
            chunk = group[j:j + max_feats]
            if len(chunk) >= 2:
                groups.append(chunk)
    return groups


class FusedEmbeddingTables(EmbeddingTable):
    """One table serving several scalar categorical columns: column f's
    rows start at ``row_offsets[f]``, and one lookup of the (B, F) offset
    ids replaces F. Where every column fits a uniform stride (the groups
    :func:`_fused_groups` makes) the rows are (F * stride, D); otherwise they
    pack tightly. ``block_name`` is ``"fused_embeddings"``."""

    def __init__(self, col_schemas: Sequence[ColumnSchema], dim: int,
                 dtype: torch.dtype = torch.float32, seed: int = 0, device=None,
                 l2_reg: float = 0.0):
        cols = list(col_schemas)
        padded = [-(-int(c.cardinality) // 8) * 8 for c in cols]
        stride = max(padded)
        uniform = (stride <= _FUSED_STRIDE_MAX
                   and stride * len(cols) * dim * 4 <= _FUSED_BYTES_MAX)
        if uniform:
            padded = [stride] * len(cols)
        else:
            warnings.warn("FusedEmbeddingTables packs its columns tightly (non-uniform "
                          "strides); Embeddings(..., fused=True) fuses only uniform-stride "
                          "groups", stacklevel=2)
        total = int(sum(padded))
        super().__init__(dim, create_categorical_column("fused_embeddings", total - 1),
                         dtype=dtype, seed=seed, device=device, l2_reg=l2_reg)
        self.features = [c.name for c in cols]
        self.schema = Schema(cols)
        self.block_name = "fused_embeddings"
        self.stride = stride if uniform else None
        self.row_offsets = [int(x) for x in np.cumsum([0] + padded[:-1])]
        self.register_buffer("offsets", torch.tensor(self.row_offsets, dtype=torch.int64,
                                                     device=self.table.device), persistent=False)

    def forward(self, inputs, context=None, **kwargs):
        local = torch.stack([inputs[name].to(torch.int64) for name in self.features], dim=1)
        emb = self._lookup(local + self.offsets, context)  # (B, F, D)
        # unbind, not emb[:, i]: its backward stacks the columns' gradients
        # into one (B, F, D) tensor, where each slice's would be a zero-filled
        # (B, F, D) tensor, all F of them summed (on the card, at batch 8192
        # and F = 26, 1.8 of a 3.3 ms step)
        return dict(zip(self.features, emb.unbind(1)))

    def extra_repr(self) -> str:
        return f"{self.input_dim}x{self.dim}, stride={self.stride}, features={self.features}"


def Embeddings(
    schema: Schema, dim: Union[int, Dict[str, int], None] = None,
    sequence_combiner: Union[str, Dict[str, Optional[str]], None] = "default",
    trainable: Union[bool, Dict[str, bool]] = True,
    infer_dim_multiplier: float = 2.0,
    l2_reg: float = 0.0,
    table_kwargs: Optional[Dict[str, dict]] = None,
    param_dtype: Optional[torch.dtype] = None, seed: int = 0, fused: bool = False,
    tt_compression_threshold: Optional[int] = None,
    tt_ranks: Union[int, tuple] = 32,
    dynamic: Union[bool, Dict[str, bool]] = False,
    dynamic_capacity: Optional[Dict[str, int]] = None,
    device=None,
) -> ParallelBlock:
    """One table per categorical domain.

    - ``dim``: an int for every table, a dict by column or domain name, or
      None to infer it from the cardinality (``infer_dim_multiplier *
      cardinality ** 0.25``, rounded up to a multiple of 8);
    - ``sequence_combiner``: ``"default"`` keeps ``SEQUENCE`` list columns
      3-D and mean-pools other list columns over their mask; a combiner's
      name (``"mean"``, ``"sum"``) pools every list column; a dict gives it
      by column;
    - ``trainable``: a bool, or a dict by domain (a frozen table is a
      buffer); ``table_kwargs``: keyword arguments of one domain's
      :class:`EmbeddingTable` (``weights=``, ``initializer=``, ...);
    - ``param_dtype=torch.bfloat16`` stores the tables bf16 at rest; they
      then train only through a row-sparse ``embedding_optimizer``
      (stochastic-rounding writes);
    - ``fused=True`` with an int ``dim`` puts the single-column scalar
      domains with default options into :class:`FusedEmbeddingTables`
      (named ``fused``, or ``fused_<i>`` for several groups; float32), the
      other domains into tables of their own;
    - ``tt_compression_threshold``: a domain of more rows than this takes a
      tensor-train table of ``tt_ranks``
      (:class:`~models_tpu_torch.inputs.tt_embedding.TTEmbeddingTable`),
      unless it is frozen or has ``table_kwargs`` (then a dense table, with
      a warning);
    - ``dynamic``: True, or a dict by domain, makes
      :class:`~models_tpu_torch.inputs.dynamic.DynamicEmbeddingTable` tables
      (slots allocated to raw ids as they come), of ``dynamic_capacity``
      rows by domain (default cardinality / 0.8 plus the probes)."""
    cat = schema.categorical
    if not len(cat):
        raise ValueError("Schema has no categorical columns")
    by_domain: Dict[str, list] = {}
    for col in cat:
        by_domain.setdefault(col.domain_name, []).append(col)

    def dim_for(domain: str, cols) -> int:
        if isinstance(dim, dict):
            for c in cols:
                if c.name in dim:
                    return dim[c.name]
            if domain in dim:
                return dim[domain]
        elif isinstance(dim, int):
            return dim
        return infer_embedding_dim(cols[0], multiplier=infer_dim_multiplier)

    def combiner_for(col: ColumnSchema) -> Optional[str]:
        if isinstance(sequence_combiner, dict):
            return sequence_combiner.get(col.name)
        if not col.is_list:
            return None
        if sequence_combiner == "default":
            return None if col.has_tag(Tags.SEQUENCE) else "mean"
        return sequence_combiner

    def tt_eligible(cols) -> bool:
        return (tt_compression_threshold is not None
                and (cols[0].cardinality or 0) > tt_compression_threshold)

    tables: Dict[str, nn.Module] = {}
    if fused and isinstance(dim, int):
        fusable = [(domain, cols[0]) for domain, cols in by_domain.items()
                   if len(cols) == 1 and not cols[0].is_list and not tt_eligible(cols)
                   and (trainable is True or (isinstance(trainable, dict)
                                              and trainable.get(domain, True)))
                   and domain not in (table_kwargs or {})]
        groups = _fused_groups([c for _, c in fusable], dim) if len(fusable) > 1 else []
        domain_of = {c.name: d for d, c in fusable}
        for gi, chunk in enumerate(groups):
            name = "fused" if len(groups) == 1 else f"fused_{gi}"
            tables[name] = FusedEmbeddingTables(chunk, dim, seed=seed + 101 * gi, device=device,
                                                l2_reg=l2_reg)
        consumed = {domain_of[c.name] for chunk in groups for c in chunk}
        by_domain = {d: cs for d, cs in by_domain.items() if d not in consumed}
    for i, (domain, cols) in enumerate(by_domain.items()):
        combiners = {combiner_for(c) for c in cols}
        combiner = next(iter(combiners)) if len(combiners) == 1 else None
        tr = trainable if isinstance(trainable, bool) else trainable.get(domain, True)
        kw = dict((table_kwargs or {}).get(domain, {}))
        if tt_eligible(cols):
            if not tr or kw:
                warnings.warn(
                    f"domain {domain!r} exceeds tt_compression_threshold but has "
                    f"{'trainable=False' if not tr else 'table_kwargs'}: using a DENSE table",
                    stacklevel=2)
            else:
                from .tt_embedding import TTEmbeddingTable

                tables[domain] = TTEmbeddingTable(dim_for(domain, cols), cols, ranks=tt_ranks,
                                                  sequence_combiner=combiner, l2_reg=l2_reg,
                                                  seed=seed + i, device=device)
                continue
        if param_dtype is not None:
            kw.setdefault("dtype", param_dtype)
        dyn = dynamic if isinstance(dynamic, bool) else dynamic.get(domain, False)
        if dyn:
            from .dynamic import DynamicEmbeddingTable

            tables[domain] = DynamicEmbeddingTable(
                dim_for(domain, cols), cols, capacity=(dynamic_capacity or {}).get(domain),
                sequence_combiner=combiner, trainable=tr, l2_reg=l2_reg, seed=seed + i,
                device=device, **kw)
            continue
        tables[domain] = EmbeddingTable(
            dim_for(domain, cols), cols, sequence_combiner=combiner, trainable=tr,
            l2_reg=l2_reg, seed=seed + i, device=device, **kw)
    return ParallelBlock(tables, block_name="embeddings", schema=cat)


class AverageEmbeddingsByWeightFeature(Block):
    """Each sequence embedding's mean weighted by a weight column of the
    batch's features (the context's), over its mask; other entries pass."""

    def __init__(self, weight_feature_name: str):
        super().__init__()
        self.weight_feature_name = weight_feature_name

    def forward(self, inputs: TensorDict, *, context=None, **kwargs):
        feats = context.features if context is not None else {}
        w = feats.get(self.weight_feature_name)
        if w is None:
            raise ValueError(f"weight feature {self.weight_feature_name} not in context")
        w_vals = w.values if isinstance(w, SequenceFeature) else w
        out = {}
        for name, v in inputs.items():
            if isinstance(v, SequenceFeature):
                weights = (w_vals * v.mask).to(v.values.dtype)
                denom = weights.sum(dim=1, keepdim=True).clamp_min(1e-9)
                out[name] = torch.einsum("bld,bl->bd", v.values, weights) / denom
            else:
                out[name] = v
        return out


class PretrainedEmbeddingsBlock(Block):
    """The schema's ``EMBEDDING`` columns as they are (pre-computed
    vectors), list columns pooled by ``sequence_combiner`` and each passed
    through ``normalizer`` where given."""

    def __init__(self, schema: Schema, sequence_combiner: Optional[str] = "mean",
                 normalizer: Optional[Callable] = None):
        emb_schema = schema.select_by_tag(Tags.EMBEDDING) if schema is not None else None
        super().__init__(schema=emb_schema, block_name="pretrained_embeddings")
        self.sequence_combiner = sequence_combiner
        self.normalizer = normalizer

    def forward(self, inputs: TensorDict, **kwargs):
        out = {}
        for name, v in inputs.items():
            if isinstance(v, SequenceFeature) and self.sequence_combiner:
                v = SEQUENCE_COMBINERS[self.sequence_combiner](v)
            if self.normalizer is not None:
                v = self.normalizer(v)
            out[name] = v
        return out


def PretrainedEmbeddings(schema: Schema, sequence_combiner: Optional[str] = "mean",
                         normalizer: Optional[Callable] = None) -> Block:
    """The reference's name for :class:`PretrainedEmbeddingsBlock`."""
    return PretrainedEmbeddingsBlock(schema, sequence_combiner, normalizer)


def EmbeddingFeatures(schema: Schema, dim: Union[int, Dict[str, int], None] = None,
                      seed: int = 0, **kwargs) -> ParallelBlock:
    """The V1 lookup block: one table per categorical domain, no combiner."""
    return Embeddings(schema, dim=dim, sequence_combiner=None, seed=seed, **kwargs)


def SequenceEmbeddingFeatures(schema: Schema, dim: Union[int, Dict[str, int], None] = None,
                              seed: int = 0, **kwargs) -> ParallelBlock:
    """The V1 sequence lookups: list columns stay (B, L, D) SequenceFeatures."""
    return Embeddings(schema, dim=dim, sequence_combiner=None, seed=seed, **kwargs)
