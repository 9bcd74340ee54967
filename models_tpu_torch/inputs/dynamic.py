"""Dynamic-vocabulary embedding tables (``models_tpu/inputs/dynamic.py``):
an id -> slot hash map on the device in front of a fixed-capacity table, so
that raw, un-categorified ids (31-bit hashes of strings, say) allocate rows
as they first arrive in training, the reference's ``sok.DynamicVariable``.

- ``hash_keys``: (capacity,) int32, ``EMPTY`` (-1) where free; probe
  position i owns table row i. The capacity is the table's padded rows, the
  JAX package's, so that every slot is the same function of an id.
- A lookup probes ``probes`` slots from ``_mix(id) % capacity`` linearly;
  the first slot holding the id wins.
- In training, an id with no slot claims the first empty slot of its
  window: one max-scatter of the ids into their candidate slots
  (``scatter_reduce_(..., "amax")`` on the key buffer, in place); two ids
  racing for a slot resolve by the larger; a loser, and an id whose whole
  window is full, falls back to the shared ``_mix(id) % capacity`` slot.
  Duplicates in a batch claim the same slot. A second column of the domain
  in the same step sees the first one's claims (the buffer is updated in
  place), and a captured graph replays the claim. Evaluation
  (``training=False``) claims nothing.
- No eviction: size the capacity at the distinct ids over 0.8.

On the row-sparse route the lookup records the slots, so the update (K7 on
the card) reaches the rows the map gave.

On a mesh (``fit(mesh=)``) every rank keeps the whole key buffer, as the
JAX package replicates it, and the table's rows are split over the model
axis as a static table's are. The JAX package runs one insert over the
global batch; here, in a training step, each rank all-gathers the raw ids of
its data line (the global batch, in its row order), runs the same map on
them against its own copy of the keys, and keeps its own rows' slots. Every
rank thus claims, races and falls back as the one global scatter does, and
the ranks' keys stay bit-equal. Evaluation claims nothing and maps its own
ids.

The hash and the map are plain torch, as the JAX package's are plain
``jnp``: uint32 arithmetic in int64 with the top bits masked after each
multiply.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import SequenceFeature
from ..parallel.collectives import all_gather
from ..parallel.mesh import DATA_AXIS
from ..schema import ColumnSchema, Domain
from .embedding import EmbeddingTable

EMPTY = -1
_PROBES = 8
_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) held in int64, in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix(ids: torch.Tensor) -> torch.Tensor:
    """The 32-bit avalanche finalizer of the JAX package's ``_mix``, as
    int64 values in [0, 2**32)."""
    x = ids.to(torch.int64) & _MASK32
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


# SipHash-2-4, pandas' ``hash_array(categorize=False)`` of an object array
_HASH_KEY = b"0123456789123456"
_M64 = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _M64


def _siphash24(data: bytes, key: bytes = _HASH_KEY) -> int:
    k0 = int.from_bytes(key[:8], "little")
    k1 = int.from_bytes(key[8:16], "little")
    v0, v1 = k0 ^ 0x736F6D6570736575, k1 ^ 0x646F72616E646F6D
    v2, v3 = k0 ^ 0x6C7967656E657261, k1 ^ 0x7465646279746573

    def rounds(n):
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & _M64
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & _M64
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & _M64
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & _M64
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    n = len(data)
    end = n - n % 8
    for i in range(0, end, 8):
        m = int.from_bytes(data[i:i + 8], "little")
        v3 ^= m
        rounds(2)
        v0 ^= m
    b = ((n & 0xFF) << 56) | int.from_bytes(data[end:], "little")
    v3 ^= b
    rounds(2)
    v0 ^= b
    v2 ^= 0xFF
    rounds(4)
    return v0 ^ v1 ^ v2 ^ v3


def string_id_hash(values) -> np.ndarray:
    """Raw string or bytes ids -> non-negative int32, the same on every run
    and host (Python's ``hash`` is salted): the JAX package's convention,
    pandas' ``hash_array(values, categorize=False)`` modulo ``2**31 - 1``,
    written out here (SipHash-2-4 with pandas' key over each value's UTF-8
    bytes, then its splitmix finalizer) so that the port needs no pandas.
    None hashes as the text "None", as pandas hashes it; an array that holds other objects is
    hashed by their ``str``, as pandas falls back."""
    arr = np.asarray(values, dtype=object).reshape(-1)
    if not all(v is None or isinstance(v, (str, bytes)) for v in arr):
        arr = arr.astype(str).astype(object)
    h = np.empty(len(arr), np.uint64)
    for i, v in enumerate(arr):
        data = b"None" if v is None else v if isinstance(v, bytes) else v.encode("utf8")
        h[i] = _siphash24(data)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint64(30)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(27)
        h *= np.uint64(0x94D049BB133111EB)
        h ^= h >> np.uint64(31)
    return (h % np.uint64(2**31 - 1)).astype(np.int32)


class DynamicEmbeddingTable(EmbeddingTable):
    """An :class:`EmbeddingTable` whose row for an id is allocated at the
    id's first training lookup (the module's note). ``capacity``: the rows
    (default the column's cardinality / 0.8 plus ``probes``); raw ids are
    any non-negative int32 and never index the table themselves. Made on
    ``device`` (default the card)."""

    def __init__(self, dim: int, col_schema: Union[ColumnSchema, Sequence[ColumnSchema]],
                 capacity: Optional[int] = None, probes: int = _PROBES, device=None, **kwargs):
        cols = [col_schema] if isinstance(col_schema, ColumnSchema) else list(col_schema)
        if capacity is None:
            card = cols[0].cardinality
            if card is None:
                raise ValueError("DynamicEmbeddingTable needs `capacity` when the column "
                                 "has no cardinality")
            capacity = int(card / 0.8) + probes
        sized = [replace(c, int_domain=Domain(min=0, max=int(capacity) - 1,
                                              name=(c.int_domain.name if c.int_domain
                                                    else c.name)))
                 for c in cols]
        super().__init__(dim, sized, device=resolve_device(device), **kwargs)
        self.capacity = int(self.padded_rows)  # the probe space is the padded rows
        self.probes = int(probes)
        self.dynamic = True
        self.register_buffer("hash_keys", torch.full((self.capacity,), EMPTY, dtype=torch.int32,
                                                     device=self.table.device))

    @property
    def num_allocated(self) -> int:
        """Slots that an id owns (a copy to the host)."""
        return int((self.hash_keys != EMPTY).sum())

    def _map_ids(self, raw: torch.Tensor, keys: torch.Tensor, training: bool) -> torch.Tensor:
        """Slots of the raw ids (B,); in training the claims are written
        into ``keys`` in place."""
        cap = self.capacity
        raw = raw.to(torch.int32)
        h = (_mix(raw) % cap).to(torch.int64)
        pos = (h[:, None] + torch.arange(self.probes, device=raw.device)) % cap  # (B, P)
        window = keys[pos]
        is_match = window == raw[:, None]
        matched = is_match.any(dim=1)

        def first(m):  # the lowest probe where m holds (0 where it nowhere does)
            return pos.gather(1, m.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0]

        match_slot = first(is_match)
        if not training:
            return torch.where(matched, match_slot, h)
        empty = window == EMPTY
        cand = first(empty)
        need = ~matched & empty.any(dim=1)
        claim = torch.where(need, raw, torch.full_like(raw, EMPTY))
        keys.scatter_reduce_(0, cand, claim, "amax")
        won = keys[cand] == raw
        return torch.where(matched, match_slot, torch.where(need & won, cand, h))

    def _slots(self, raw: torch.Tensor, context, training: bool) -> torch.Tensor:
        """Slots of this rank's raw ids (B,): in a mesh step's training the
        map runs over the data line's gathered ids (the module's note)."""
        mesh = context.get("mesh") if training and context is not None else None
        g = mesh.group(DATA_AXIS) if mesh is not None else None
        if g is None or g.size == 1:
            return self._map_ids(raw, self.hash_keys, training)
        n = raw.shape[0]
        every = all_gather(raw.to(torch.int32).contiguous(), g)
        return self._map_ids(every, self.hash_keys, training)[g.index * n:(g.index + 1) * n]

    def _call_single(self, value, context, feature: Optional[str] = None, training=False):
        if isinstance(value, SequenceFeature):
            slots = self._slots(value.values.reshape(-1), context, training)
            mapped = SequenceFeature(slots.reshape(value.values.shape), value.mask)
            return super()._call_single(mapped, context, feature)
        slots = self._slots(value.reshape(-1), context, training)
        return super()._call_single(slots.reshape(value.shape), context, feature)

    def forward(self, inputs, context=None, training: bool = False, **kwargs):
        if isinstance(inputs, dict):
            return {n: self._call_single(inputs[n], context, n, training)
                    for n in self.features if n in inputs}
        return self._call_single(inputs, context, training=training)

    def extra_repr(self) -> str:
        return f"capacity={self.capacity}x{self.dim}, features={self.features}"
