"""A mesh of ranks with a ``data`` and a ``model`` axis
(``models_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over every device and lets
``shard_map`` and XLA move the data. The port runs one process per rank
(:func:`~models_tpu_torch.parallel.distributed.initialize`), and a
:class:`Mesh` is the world's ranks laid out as JAX lays out its devices,
``np.arange(world).reshape(dims)``: with two axes, rank r sits at
``(r // model, r % model)``. The mesh keeps one process group for each line
along each axis (an :class:`~models_tpu_torch.parallel.collectives.AxisGroup`):

- ``data``: batches are split over it (:func:`shard_batch`); the ranks of a
  data line hold the same shards and see different rows;
- ``model``: embedding tables and their row-sparse slots are split by rows
  over it (:func:`shard_state`, the rules :data:`DEFAULT_RULES`); the ranks
  of a model line see the same rows and hold different shards.

A parameter's or buffer's name (``named_parameters()``, ``.`` read as
``/``) is matched against the rules' regexes, the first match wins, and its
spec (one mesh axis or None a dimension) applies only where every sharded
dimension divides the axis (:func:`_spec_fits`): a table whose padded rows do
not divide the model axis stays whole on every rank, as in the JAX package.
A row-sharded table records its :class:`RowShard`, which its lookups and its
row-sparse update read; its slots follow it.

Host utilities: :func:`process_index`, :func:`is_chief`, :func:`chief_only`,
:func:`shared_seed`.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.device import DeviceLike, resolve_device
from ..core.types import SequenceFeature
from . import distributed
from .collectives import AxisGroup, all_gather, broadcast

DATA_AXIS = "data"
MODEL_AXIS = "model"

# embedding table rows (and their row-sparse slots) over the model axis;
# everything else whole on every rank
DEFAULT_RULES: List[Tuple[str, tuple]] = [
    (r"\btable\b", (MODEL_AXIS, None)),
    (r"\bsparse_slots\b", (MODEL_AXIS, None)),
]

Spec = Optional[tuple]


class Mesh:
    """The world's ranks as a grid of named axes (see the module's note).
    ``device`` is this rank's, ``backend`` the process group's (``None``
    for a mesh of one rank with no process group)."""

    def __init__(self, shape: Dict[str, int], device: torch.device, backend: Optional[str]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.device = device
        self.backend = backend
        if dist.is_initialized():
            self.rank, self.world = dist.get_rank(), dist.get_world_size()
        else:
            self.rank, self.world = 0, 1
        dims = tuple(self.shape.values())
        if int(np.prod(dims)) != self.world:
            raise ValueError(f"Mesh shape {dims} does not match {self.world} ranks")
        grid = np.arange(self.world).reshape(dims)
        self.coords = tuple(int(c) for c in np.argwhere(grid == self.rank)[0])
        self._groups: Dict[str, AxisGroup] = {}
        timeout = None
        if dist.is_initialized():
            import datetime

            timeout = datetime.timedelta(seconds=distributed.timeout())
        for ax, name in enumerate(self.axis_names):
            # every rank makes every group, in one order (new_group's rule)
            lines = np.moveaxis(grid, ax, -1).reshape(-1, dims[ax])
            for line in lines:
                ranks = tuple(int(r) for r in line)
                pg = None
                if len(ranks) > 1:
                    pg = dist.new_group(list(ranks), timeout=timeout)
                if self.rank in ranks:
                    self._groups[name] = AxisGroup(name, ranks, pg, ranks.index(self.rank),
                                                   backend or "none")
        world = tuple(range(self.world))
        self._groups["__world__"] = AxisGroup(
            "__world__", world, dist.group.WORLD if self.world > 1 else None, self.rank,
            backend or "none")

    def size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)] if axis in self.shape else 0

    def group(self, axis: str) -> AxisGroup:
        """The ranks of this rank's line along ``axis`` (a group of one
        where the mesh has no such axis)."""
        if axis not in self._groups:
            return AxisGroup(axis, (self.rank,), None, 0, self.backend or "none")
        return self._groups[axis]

    @property
    def world_group(self) -> AxisGroup:
        return self._groups["__world__"]

    @property
    def fingerprint(self) -> tuple:
        """What optimizer state placed on this mesh depends on."""
        return (tuple(self.shape.items()), self.world, self.backend)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank} at {self.coords}, {self.backend})"


def make_mesh(shape: Union[Dict[str, int], Sequence[int], None] = None,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              device: DeviceLike = None) -> Mesh:
    """A mesh over the world's ranks, e.g. ``{"data": 2, "model": 2}``; by
    default every rank on the data axis. ``device``: this rank's, by
    default the one :func:`~models_tpu_torch.parallel.distributed.initialize`
    chose, else the card (raising without one); on the CPU pass
    ``device="cpu"``, over a ``gloo`` group. Without a process group the
    mesh holds one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = {DATA_AXIS: world, MODEL_AXIS: 1}
    if not isinstance(shape, dict):
        shape = dict(zip(axis_names, (int(d) for d in shape)))
    dev = resolve_device(device if device is not None else distributed.rank_device())
    backend = distributed.backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"a mesh over an nccl group lives on the card, not on {dev}")
    return Mesh(shape, dev, backend)


# ---------------------------------------------------------------------------
# placement rules
# ---------------------------------------------------------------------------

def _path(name: str) -> str:
    return name.replace(".", "/")


def _spec_fits(spec: tuple, shape, mesh: Mesh) -> bool:
    if len(spec) > len(shape):
        return False
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        size = int(np.prod([mesh.size(a) for a in axes]))
        if dim % size != 0:
            return False
    return True


def named_tensors(tree) -> Dict[str, torch.Tensor]:
    """A module's parameters and buffers by name, each tensor once (under
    its first name); a dict as it is."""
    if isinstance(tree, nn.Module):
        out: Dict[str, torch.Tensor] = {}
        seen = set()
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                out[name] = t
        return out
    return dict(tree)


def sharding_for_tree(tree, mesh: Mesh, rules=None) -> Dict[str, Spec]:
    """Each tensor's spec by name (None: whole on every rank), from the
    path-regex ``rules`` (default :data:`DEFAULT_RULES`); ``tree`` is a
    module (its parameters and buffers) or a dict of tensors or arrays."""
    rules = DEFAULT_RULES if rules is None else rules
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    out: Dict[str, Spec] = {}
    for name, t in named_tensors(tree).items():
        out[name] = None
        path = _path(name)
        for pat, spec in compiled:
            if pat.search(path):
                if spec is not None and _spec_fits(tuple(spec), tuple(t.shape), mesh) \
                        and any(a is not None for a in spec):
                    out[name] = tuple(spec)
                break
    return out


def shard_slices(spec: tuple, shape, mesh: Mesh) -> tuple:
    """The index of this rank's slice of a tensor of ``shape`` under
    ``spec``."""
    out = []
    for dim, axis in zip(shape, spec):
        if axis is None:
            out.append(slice(None))
            continue
        n, i = mesh.size(axis), mesh.index(axis)
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


class RowShard(NamedTuple):
    """A table split by rows over ``axis``: this rank holds rows ``[index *
    rows, (index + 1) * rows)`` of ``full_rows``."""

    mesh: Mesh
    axis: str
    index: int
    count: int
    rows: int
    full_rows: int

    @property
    def lo(self) -> int:
        return self.index * self.rows


def _tables(model: nn.Module):
    from ..inputs.embedding import EmbeddingTable

    return [(n, m) for n, m in model.named_modules() if isinstance(m, EmbeddingTable)]


def _table_names(tname: str, table) -> List[str]:
    pre = f"{tname}." if tname else ""
    slots = table.sparse_slots.keys() if table.sparse_slots is not None else []
    return [pre + "table"] + [f"{pre}sparse_slots.{k}" for k in slots]


@torch.no_grad()
def shard_state(tree, mesh: Mesh, rules=None):
    """Keep this rank's slice of each tensor the rules shard.

    A dict of tensors (a loaded state, an optimizer state by name) gives a
    new dict. A module is sharded in place (each tensor keeps its object, its
    ``.data`` the slice) and is returned; a row-sharded table records its
    :class:`RowShard`, and its slots, those it has and those made later,
    follow it. What is sharded already stays as it is. On a mesh of one rank
    nothing is split. A spec over a model axis of one keeps the whole table
    as its one shard: its lookups and row-sparse updates then take the
    sharded routes, whose gradients move as (ids, rows) over the data axis,
    never as the table."""
    if not isinstance(tree, nn.Module):
        specs = sharding_for_tree(tree, mesh, rules)
        return {k: (v[shard_slices(specs[k], v.shape, mesh)].clone() if specs.get(k) else v)
                for k, v in tree.items()}
    model = tree
    if mesh.world == 1:
        return model  # one rank holds everything: nothing to split
    done: Dict[str, tuple] = model.__dict__.setdefault("_mesh_specs", {})
    specs = sharding_for_tree(model, mesh, rules)
    tensors = named_tensors(model)
    owned_by_tables = set()
    for tname, table in _tables(model):
        names = _table_names(tname, table)
        owned_by_tables.update(names)
        spec = specs.get(names[0])
        if table.shard is not None or spec is None:
            continue
        if spec[0] != MODEL_AXIS or any(a is not None for a in spec[1:]):
            raise NotImplementedError(f"{names[0]}: a table is sharded by rows over the model "
                                      f"axis only, not by {spec}")
        for name in names:
            t = tensors[name]
            t.data = t.data[shard_slices(spec, t.shape, mesh)].clone()
        n = mesh.size(MODEL_AXIS)
        table.shard = RowShard(mesh, MODEL_AXIS, mesh.index(MODEL_AXIS), n,
                               table.padded_rows // n, table.padded_rows)
    for name, spec in specs.items():
        if spec is None or name in done or name in owned_by_tables:
            continue
        t = tensors[name]
        t.data = t.data[shard_slices(spec, t.shape, mesh)].clone()
        done[name] = spec
    model.__dict__["_mesh_of_state"] = mesh
    return model


def gather_full(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's slice under ``spec``:
    gathered over each sharded axis's group (a collective: every rank of
    the group calls it)."""
    out = t.detach()
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        g = mesh.group(axis)
        moved = out.movedim(dim, 0).contiguous()
        out = all_gather(moved, g).movedim(0, dim)
    return out


def sharded_names(model: nn.Module) -> Dict[str, tuple]:
    """The names of the model's tensors held as slices, with their specs:
    the sharded tables with their slots, and what else a module records
    (``_mesh_specs``: the rules' other matches, a split top-k index)."""
    out: Dict[str, tuple] = {}
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        for name, spec in m.__dict__.get("_mesh_specs", {}).items():
            out[pre + name] = spec
    for tname, table in _tables(model):
        if table.shard is not None:
            for name in _table_names(tname, table):
                out[name] = (table.shard.axis, None)
    return out


def state_mesh(model: nn.Module) -> Optional[Mesh]:
    """The mesh the model's state is sharded on, or None."""
    for _, m in model.named_modules():
        if m.__dict__.get("_mesh_specs") and m.__dict__.get("_mesh_of_state") is not None:
            return m.__dict__["_mesh_of_state"]
    for _, table in _tables(model):
        if table.shard is not None:
            return table.shard.mesh
    return None


@torch.no_grad()
def full_state(model: nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``state`` (the model's tensors by name) with each sharded tensor
    gathered whole, on the host (every rank of each group takes part)."""
    specs, mesh = sharded_names(model), state_mesh(model)
    if mesh is None:
        return state
    return {k: (gather_full(v, specs[k], mesh).cpu() if k in specs else v)
            for k, v in state.items()}


@torch.no_grad()
def unshard_state(model: nn.Module) -> nn.Module:
    """Make every sharded tensor of ``model`` whole again, in place (a
    collective), and forget the tables' shards."""
    specs, mesh = sharded_names(model), state_mesh(model)
    if mesh is None:
        return model
    tensors = named_tensors(model)
    for name, spec in specs.items():
        t = tensors[name]
        t.data = gather_full(t, spec, mesh).to(t.device)
    for _, table in _tables(model):
        table.shard = None
    for _, m in model.named_modules():
        m.__dict__.pop("_mesh_specs", None)
        m.__dict__.pop("_mesh_of_state", None)
        if isinstance(m.__dict__.get("mesh"), Mesh):  # a split top-k index's
            m.mesh = None
    return model


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a batch: every leaf (tensor, array,
    :class:`SequenceFeature`) whose leading size divides the data axis keeps
    rows ``[d * B / dp, (d + 1) * B / dp)`` for the rank's data coordinate
    d; any other leaf stays whole."""
    dp, d = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, SequenceFeature):
            return SequenceFeature(place(x.values), place(x.mask))
        if dp > 1 and getattr(x, "ndim", 0) >= 1 and x.shape[0] % dp == 0:
            n = x.shape[0] // dp
            return x[d * n:(d + 1) * n]
        return x

    return place(batch)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """The chief's tensors on every rank (a broadcast over the world; a
    module's parameters and buffers in place, a dict's tensors in place)."""
    g = mesh.world_group
    for t in named_tensors(tree).values():
        if torch.is_tensor(t):
            broadcast(t.data, g)
    return tree


# ---------------------------------------------------------------------------
# host utilities
# ---------------------------------------------------------------------------

def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_chief() -> bool:
    return process_index() == 0


def chief_only(fn):
    """Run ``fn`` on the chief only (saves, logs); None elsewhere."""

    def wrapper(*args, **kwargs):
        if is_chief():
            return fn(*args, **kwargs)
        return None

    return wrapper


def shared_seed(base_seed: int = 0) -> int:
    """The chief's ``base_seed`` on every rank (broadcast over the world
    where there is a process group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return int(base_seed)
    dev = distributed.rank_device() or torch.device("cpu")
    t = torch.tensor([int(base_seed)], dtype=torch.int64)
    if distributed.backend() == "nccl":
        t = t.to(dev)
    dist.broadcast(t, 0)
    return int(t.item())


def barrier() -> None:
    """Wait for every rank of the world."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
