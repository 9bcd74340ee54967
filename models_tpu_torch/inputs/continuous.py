"""Continuous features (``models_tpu/inputs/continuous.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.block import Block
from ..core.types import TensorDict
from ..schema import Schema


class Continuous(Block):
    """Select the continuous columns and turn each (B,) column into (B, 1)
    float32."""

    def __init__(self, schema: Optional[Schema] = None):
        if schema is not None and len(schema.continuous):
            schema = schema.continuous
        super().__init__(schema=schema, block_name="continuous")

    def forward(self, inputs: TensorDict, **kwargs):
        names = self.schema.column_names if self.schema is not None else list(inputs)
        out = {}
        for name in names:
            if name not in inputs:
                continue
            v = inputs[name]
            out[name] = (v[:, None] if v.ndim == 1 else v).to(torch.float32)
        return out
