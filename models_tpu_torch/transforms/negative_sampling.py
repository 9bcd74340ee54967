"""In-batch negative rows for training a binary ranking model without
logged negatives (``models_tpu/transforms/negative_sampling.py``), as a
``fit(pre=)`` transform.

For each of ``n_per_positive`` copies, every row's item columns are taken
from another row of the batch (a draw of B row indices), its other columns
kept, and its targets set to 0: the batch grows from B to (1 + n) B rows,
a static shape. Every target is zeroed, as in the JAX package (whose
``targets_to_zero`` changes nothing there, and is not taken here). The
draws come from the block's own generator
(:class:`~models_tpu_torch.core.block.RandomBlock`; the JAX package folds
the step into its key, so the two packages draw different rows).
"""

from __future__ import annotations

import torch

from ..core.block import RandomBlock
from ..core.types import SequenceFeature, TensorDict
from ..schema import Schema, Tags


class InBatchNegatives(RandomBlock):
    def __init__(self, schema: Schema, n_per_positive: int = 1, seed: int = 0, device=None):
        super().__init__(seed=seed, device=device, schema=schema)
        self.n = int(n_per_positive)
        self.item_cols = schema.select_by_tag(Tags.ITEM).column_names

    def draw(self, batch_size: int, device) -> torch.Tensor:
        """(n, B) int64 row indices in [0, B): the rows whose items each
        copy takes."""
        return torch.randint(0, batch_size, (self.n, batch_size), generator=self.generator,
                             device=device)

    def forward(self, inputs: TensorDict, *, targets=None, training: bool = True, **kwargs):
        if not training:
            return (inputs, targets) if targets is not None else inputs
        some = next(v for v in inputs.values() if hasattr(v, "shape"))
        rows = self.draw(some.shape[0], some.device)

        def tile(name, v):
            if name not in self.item_cols:
                copies = [v] * (self.n + 1)
            elif isinstance(v, SequenceFeature):
                copies = [v] + [SequenceFeature(v.values[r], v.mask[r]) for r in rows]
            else:
                copies = [v] + [v[r] for r in rows]
            if isinstance(v, SequenceFeature):
                return SequenceFeature(torch.cat([c.values for c in copies]),
                                       torch.cat([c.mask for c in copies]))
            return torch.cat(copies)

        out = {name: tile(name, v) for name, v in inputs.items()}

        def zero_pad(t):
            return torch.cat([t, t.new_zeros((self.n * t.shape[0],) + tuple(t.shape[1:]))])

        if isinstance(targets, dict):
            targets = {name: zero_pad(t) for name, t in targets.items()}
        elif targets is not None:
            targets = zero_pad(targets)
        return out, targets
