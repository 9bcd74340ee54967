"""SequentialBlock and ParallelBlock (``models_tpu/core/combinators.py``),
covering what the towers use."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from ..schema import Schema
from .block import Block
from .types import TensorDict


class SequentialBlock(Block):
    """Runs blocks in order; nested plain SequentialBlocks are flattened, so
    parameter paths match the JAX package's."""

    def __init__(self, blocks: Sequence[nn.Module], block_name: Optional[str] = None):
        super().__init__(block_name=block_name)
        flat = []
        for b in blocks:
            if type(b) is SequentialBlock:
                flat.extend(b.layers)
            else:
                flat.append(b)
        self.layers = nn.ModuleList(flat)
        for b in flat:
            if getattr(b, "schema", None) is not None:
                self.schema = b.schema
                break

    def forward(self, inputs, **kwargs):
        out = inputs
        for layer in self.layers:
            out = layer(out, **kwargs)
        return out

    def __getitem__(self, idx):
        return self.layers[idx]

    def __len__(self):
        return len(self.layers)


class ParallelBlock(Block):
    """Named branches over the same input -> one dict of outputs.

    A branch with a schema sees only its schema's columns of a dict input;
    dict outputs are flattened into the result; ``aggregation`` then merges it.
    """

    def __init__(
        self,
        branches: Dict[str, nn.Module],
        aggregation: Optional[nn.Module] = None,
        block_name: Optional[str] = None,
        schema: Optional[Schema] = None,
    ):
        super().__init__(schema=schema, block_name=block_name)
        self.branches = nn.ModuleDict(branches)
        self.aggregation = aggregation

    @staticmethod
    def _branch_inputs(branch, inputs):
        bschema = getattr(branch, "schema", None)
        if isinstance(inputs, dict) and bschema is not None and len(bschema):
            keep = {k: v for k, v in inputs.items() if k in bschema}
            if keep:
                return keep
        return inputs

    def forward(self, inputs, **kwargs):
        outputs: TensorDict = {}
        for name, branch in self.branches.items():
            out = branch(self._branch_inputs(branch, inputs), **kwargs)
            if isinstance(out, dict):
                for k, v in out.items():
                    if k in outputs:
                        raise ValueError(f"Duplicate output key {k!r} in ParallelBlock")
                    outputs[k] = v
            else:
                outputs[name] = out
        if self.aggregation is not None:
            return self.aggregation(outputs, **kwargs)
        return outputs
