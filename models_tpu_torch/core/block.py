"""Block: the composable unit of the port (``models_tpu/core/block.py``).

A Block is a ``torch.nn.Module`` that may carry a ``schema``; combinators use it
to route each branch only the columns it declares. ``forward`` takes a tensor or
a ``Dict[str, tensor | SequenceFeature]`` and keyword arguments it may ignore.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..schema import Schema


class Block(nn.Module):
    def __init__(self, schema: Optional[Schema] = None, block_name: Optional[str] = None):
        super().__init__()
        self.schema = schema
        self.block_name = block_name or type(self).__name__

    def forward(self, inputs, **kwargs):  # pragma: no cover - overridden
        raise NotImplementedError


class RandomBlock(Block):
    """A block that draws from its own ``torch.Generator`` on its device,
    seeded by ``seed``. ``models/step_graph.py`` registers the generator of
    every such block on the card with each captured graph, so that every
    replay draws anew (the JAX package derives its draws from (seed, step),
    and a captured graph's step is frozen). Moving the block to another
    device seeds a generator there anew."""

    def __init__(self, seed: int = 0, device=None, **kwargs):
        super().__init__(**kwargs)
        self.seed = seed
        self.generator = torch.Generator(torch.device(device or "cpu")).manual_seed(seed)

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        dev = fn(torch.empty(0, device=self.generator.device)).device
        if dev != self.generator.device:
            self.generator = torch.Generator(dev).manual_seed(self.seed)
        return out


def fresh_copy(block: nn.Module, salt: int) -> nn.Module:
    """A deep copy of ``block`` with its weights drawn anew, each from a
    generator seeded by ``7919 * salt`` and its position: embedding tables
    truncated-normal (sigma 0.05, as made), other weights of two or more
    dimensions (Dense kernels) glorot-uniform; biases and norms kept. The
    JAX package re-seeds its lazy initialisers by the same salt; the draws
    differ, as every draw of the two packages does. Used where one block
    would otherwise serve twice: both towers of a two-tower model, the
    experts of a group (``blocks/experts.py``), a tower cloned for each
    task (``outputs/tasks.py::PredictionTasks``)."""
    import copy

    cp = copy.deepcopy(block)
    with torch.no_grad():
        for i, (name, p) in enumerate(cp.named_parameters()):
            if p.ndim < 2 or not p.is_floating_point():
                continue
            w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            gen = torch.Generator(p.device).manual_seed(7919 * salt + i)
            if name.split(".")[-1] == "table":
                nn.init.trunc_normal_(w, std=0.05, a=-0.1, b=0.1, generator=gen)
            else:
                nn.init.xavier_uniform_(w, generator=gen)
            p.copy_(w)
    return cp
