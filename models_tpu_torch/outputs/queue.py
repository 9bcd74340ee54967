"""Cross-batch negatives from a FIFO ring of past positives
(``models_tpu/outputs/queue.py``): :class:`FIFOQueue` and
:class:`CachedCrossBatchSampler`.

The ring (``embeddings``, ``ids``, ``cursor``) is registered buffers on the
model's device. An enqueue is index arithmetic there: every slot gathers the
row it ends up holding, so the cursor is never read on the host and a
captured chunk of k training steps replays it. The sampler never writes the
ring during the forward: autograd may have saved it for the backward (a
head whose only sampler is the queue multiplies the query by it). It
records the new ring in the context's ``state_updates``, and the engine
copies it in place (never rebinding the buffers, which a captured graph
holds by address) after the backward and the optimizer step, as the JAX
package writes its functional state updates into the step's output state.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.block import Block
from .sampling import Candidate, CandidateSampler, global_candidates


class FIFOQueue(Block):
    """A ring of ``capacity`` (id, embedding) pairs; unfilled slots have id
    -1. ``cursor`` is the next slot to write."""

    def __init__(self, capacity: int, dim: int, device=None):
        super().__init__()
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.register_buffer("embeddings", torch.zeros(self.capacity, self.dim, device=device))
        self.register_buffer("ids", torch.full((self.capacity,), -1, dtype=torch.int32,
                                               device=device))
        self.register_buffer("cursor", torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def enqueue_functional(self, ids: torch.Tensor, embeddings: torch.Tensor):
        """(embeddings, ids, cursor) after enqueueing ``n`` rows, as new
        tensors. The last ``min(n, capacity)`` rows survive; kept row i lands
        in slot ``(cursor + n - m + i) % capacity``, so with n >= capacity
        the ring is the last rows rolled by the new cursor, as the JAX
        package's."""
        n, cap = int(ids.shape[0]), self.capacity
        m = min(n, cap)
        emb = embeddings.detach()[n - m:].to(self.embeddings.dtype)
        kept = ids[n - m:].to(torch.int32)
        start = self.cursor.to(torch.int64)
        # slot j holds kept row (j - base) mod cap where that is below m
        base = start + (n - m)
        offset = torch.remainder(torch.arange(cap, device=start.device) - base, cap)
        written = offset < m
        src = offset.clamp(max=m - 1)
        new_emb = torch.where(written[:, None], emb.index_select(0, src), self.embeddings)
        new_ids = torch.where(written, kept.index_select(0, src), self.ids)
        new_cursor = torch.remainder(start + n, cap).to(torch.int32)
        return new_emb, new_ids, new_cursor

    @torch.no_grad()
    def enqueue(self, ids: torch.Tensor, embeddings: torch.Tensor) -> None:
        """Enqueue now, outside a training step."""
        for buf, value in zip((self.embeddings, self.ids, self.cursor),
                              self.enqueue_functional(ids, embeddings)):
            buf.copy_(value)

    def snapshot(self) -> Candidate:
        """The ring as candidates; unfilled slots ``valid=False``."""
        return Candidate(id=self.ids, embedding=self.embeddings, valid=self.ids >= 0)


class CachedCrossBatchSampler(CandidateSampler):
    """Negatives: the last ``capacity`` positives of earlier training steps.
    The snapshot is taken before this step's positives are enqueued, so
    that ``["in-batch", CachedCrossBatchSampler()]`` scores no positive
    twice. Enqueues only in training; the new ring goes to the context's
    ``state_updates`` (the module's note), or, called without a context, is
    written at once."""

    def __init__(self, capacity: int = 4096, dim: int = 64, device=None):
        super().__init__()
        self.queue = FIFOQueue(capacity, dim, device=device)

    def forward(self, positive: Candidate, *, training: bool = False, step=None,
                context=None, **kwargs):
        snapshot = self.queue.snapshot()
        if training and positive.embedding is not None and positive.id is not None:
            # under a mesh the ring holds the global batch's rows
            positive = global_candidates(positive, context)
            new = self.queue.enqueue_functional(positive.id, positive.embedding)
            bufs = (self.queue.embeddings, self.queue.ids, self.queue.cursor)
            if context is not None:
                context.setdefault("state_updates", []).extend(zip(bufs, new))
            else:
                # the snapshot must not see the write
                snapshot = Candidate(id=self.queue.ids.clone(),
                                     embedding=self.queue.embeddings.clone(),
                                     valid=snapshot.valid)
                with torch.no_grad():
                    for buf, value in zip(bufs, new):
                        buf.copy_(value)
        return snapshot


def apply_state_updates(updates: Optional[list]) -> None:
    """Write each (buffer, value) of a step's ``state_updates`` in place."""
    if not updates:
        return
    with torch.no_grad():
        for buf, value in updates:
            buf.copy_(value)
