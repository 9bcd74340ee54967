"""Mesh distribution (``models_tpu/parallel``): ranks joined by
``torch.distributed`` (:mod:`.distributed`), a mesh of them with a ``data``
and a ``model`` axis and the placement rules (:mod:`.mesh`), the collectives
a step runs over the mesh's lines (:mod:`.collectives`), and a launcher for
the ranks of one host (:mod:`.launch`)."""

from .distributed import initialize, local_loader_kwargs, shutdown
from .mesh import (DATA_AXIS, DEFAULT_RULES, MODEL_AXIS, Mesh, RowShard, barrier, chief_only,
                   full_state, is_chief, make_mesh, process_index, replicate, shard_batch,
                   shard_state, shared_seed, sharding_for_tree, unshard_state)

__all__ = [
    "DATA_AXIS", "DEFAULT_RULES", "MODEL_AXIS", "Mesh", "RowShard", "barrier", "chief_only",
    "full_state", "initialize", "is_chief", "local_loader_kwargs", "make_mesh",
    "process_index", "replicate", "shard_batch", "shard_state", "shared_seed",
    "sharding_for_tree", "shutdown", "unshard_state",
]
