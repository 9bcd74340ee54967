"""Block: the composable unit of the port (``models_tpu/core/block.py``).

A Block is a ``torch.nn.Module`` that may carry a ``schema``; combinators use it
to route each branch only the columns it declares. ``forward`` takes a tensor or
a ``Dict[str, tensor | SequenceFeature]`` and keyword arguments it may ignore.
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from ..schema import Schema


class Block(nn.Module):
    def __init__(self, schema: Optional[Schema] = None, block_name: Optional[str] = None):
        super().__init__()
        self.schema = schema
        self.block_name = block_name or type(self).__name__

    def forward(self, inputs, **kwargs):  # pragma: no cover - overridden
        raise NotImplementedError
