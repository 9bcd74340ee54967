"""Carry a JAX model's parameters, and its row-sparse optimizer slots, over to
its port.

The caller flattens the JAX side: ``{"/".join(path): numpy array}`` over
``nnx.state(model, nnx.Param)`` for the parameters (or over
``nnx.state(model, nnx.Variable)`` without the slots, which adds BatchNorm's
running ``mean`` and ``var``), and over the ``sparse_slots`` entries of
``nnx.state(model, nnx.Variable)`` for the slots. The port's module tree
mirrors the JAX attribute names, so a key maps to the parameter or buffer of
the same path (a module name may hold a ``/``, as a head's
``"click/BinaryOutput"`` does), except that a Dense ``kernel`` (in, out)
becomes the port's ``weight`` (out, in). What is carried:

- every parameter, in its own dtype: a bf16 embedding table stays bf16, bit
  for bit (the array's dtype must be the port parameter's);
- embedding tables whole, padding rows included, the fused tables too;
  ``DenseMaybeLowRank``'s ``u`` and ``v`` (the cross layers') in the JAX
  layout;
- BatchNorm's running statistics, where the caller gives them;
- the session models' transformer in the JAX layout ((in, out) weights
  kept as they are): each layer's ``wq``, ``wk``, ``wv``, ``wo`` and their
  biases, ``w1``, ``w2``, ``b1``, ``b2``, the LayerNorms ``ln1``, ``ln2`` and
  ``final_ln``, XLNet's ``wr``, ``u`` and ``v``, ``pos_emb``, the Dense
  ``in_proj`` and ``_ProjectToTableDim.dense``, and
  ``ReplaceMaskedEmbeddings.mask_embedding``;
- the retrieval zoo's paths as they stand: the matrix factorization's
  ``_query/block/table`` (its ``EmbeddingEncoder``) and
  ``blocks/1/table/table`` (the head's tied item table), YouTube-DNN's
  query tower and tied table; a cross-batch queue's ring
  (``.../samplers/<i>/queue/embeddings``, ``ids``, ``cursor``), which the
  caller gives from ``nnx.state(model, nnx.Variable)``;
- the multi-task blocks' paths as they stand: each expert's MLP
  (``.../experts/experts/<i>/layers/<j>/kernel``), each gate's bias-free
  ``gate`` kernel, CGC's ``shared_experts``, ``task_experts/<task>``,
  ``task_gates/<task>`` and ``shared_gate``, PLE's layers (flattened into
  the body's ``layers``), and ``ParallelPredictionBlock``'s
  ``heads/<head>``, ``bias_block`` and ``bias_logit``;
- the slice of PR 16's state: layers that built at a build pass (load
  after both sides have built: ``model.build(data)``), a frozen table's
  rows (``trainable=False``: a buffer, from ``nnx.Variable`` state), a
  dynamic table's ``hash_keys`` (an int32 buffer), a TT table's
  ``core1``..``core3`` and Wide&Deep's wide kernel
  (``.../branches/wide/linear/kernel``, (sum of widths, 1));
- the slots (``.../<table>/sparse_slots/<acc|m|v>``, float32) onto the
  table's ``sparse_slots`` buffers, which ``fit`` then keeps when they are
  the ones its embedding optimizer needs.

The top-k index is not carried: the port rebuilds it from its own candidate
tower. Neither is the dense optimizer's state.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .inputs.embedding import EmbeddingTable, SparseSlots


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16 of its own (the JAX side's is ml_dtypes'): carry its bits
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def load_jax_params(module: nn.Module, flat: Dict[str, np.ndarray],
                    slots: Optional[Dict[str, np.ndarray]] = None) -> nn.Module:
    """Copy ``flat`` into ``module``'s parameters (and buffers) and
    ``slots`` onto its tables. Raises on a key that names no parameter,
    buffer or table, on a shape or dtype mismatch, and on any parameter left
    unset."""
    params = dict(module.named_parameters())
    # the port's names by their JAX path: "." and "/" both separate
    targets = {name.replace(".", "/"): (name, t)
               for name, t in list(params.items()) + list(module.named_buffers())}
    unset = set(params)
    for key, value in flat.items():
        parts = key.split("/")
        arr = np.asarray(value)
        if parts[-1] == "kernel":
            parts, arr = parts[:-1] + ["weight"], arr.T
        if "/".join(parts) not in targets:
            raise KeyError(f"JAX parameter {key!r} has no counterpart in the port")
        name, p = targets["/".join(parts)]
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"{key!r}: JAX {tuple(t.shape)} {t.dtype} != port "
                             f"{tuple(p.shape)} {p.dtype}")
        with torch.no_grad():
            p.copy_(t)
        unset.discard(name)
    if unset:
        raise ValueError(f"port parameters left unset: {sorted(unset)}")

    by_table: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in (slots or {}).items():
        parts = key.split("/")
        if len(parts) < 3 or parts[-2] != "sparse_slots":
            raise KeyError(f"{key!r} is no .../sparse_slots/<name> entry")
        by_table.setdefault(".".join(parts[:-2]), {})[parts[-1]] = _tensor(np.asarray(value))
    for path, values in by_table.items():
        table = module.get_submodule(path)
        if not isinstance(table, EmbeddingTable):
            raise KeyError(f"{path!r} is no embedding table in the port")
        shape = tuple(table.table.shape)
        for name, t in values.items():
            if tuple(t.shape) != shape or t.dtype != torch.float32:
                raise ValueError(f"slot {path}/{name}: {tuple(t.shape)} {t.dtype}, the table "
                                 f"wants {shape} float32")
        table.sparse_slots = SparseSlots(
            {n: t.to(table.table.device) for n, t in values.items()})
    return module
