"""Combinators (``models_tpu/core/combinators.py``): ``SequentialBlock``,
``ParallelBlock``, ``Filter``, ``AsTabular``, ``ResidualBlock``,
``WithShortcut``, ``Cond`` and ``MapValues``.

A ``ParallelBlock`` branch with a schema sees only its schema's columns of a
dict input (this routes USER columns to a query tower and ITEM columns to a
candidate tower). Nested plain ``SequentialBlock``\\ s are flattened, so that
parameter paths match the JAX package's (``load_jax_params``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ..schema import Schema, Tags
from .aggregation import TabularAggregation
from .block import Block, as_block, call_block
from .types import SequenceFeature, TensorDict


def _maybe_block(obj) -> Optional[nn.Module]:
    return as_block(obj) if obj is not None else None


class SequentialBlock(Block):
    """Runs ``pre``, the blocks in order and ``post``, each taking the one
    before's output. ``out_features`` is the last block's, where it has one."""

    def __init__(self, blocks: Sequence, pre=None, post=None, block_name: Optional[str] = None):
        super().__init__(block_name=block_name)
        flat: List[nn.Module] = []
        for b in blocks:
            b = as_block(b)
            if type(b) is SequentialBlock and b.pre is None and b.post is None:
                flat.extend(b.layers)
            else:
                flat.append(b)
        self.layers = nn.ModuleList(flat)
        self.pre = _maybe_block(pre)
        self.post = _maybe_block(post)
        self.out_features = getattr(flat[-1], "out_features", None) if flat else None
        for b in flat:
            if getattr(b, "schema", None) is not None:
                self.schema = b.schema
                break

    def forward(self, inputs, **kwargs):
        out = inputs
        if self.pre is not None:
            out = call_block(self.pre, out, **kwargs)
        for layer in self.layers:
            out = call_block(layer, out, **kwargs)
        if self.post is not None:
            out = call_block(self.post, out, **kwargs)
        return out

    def __getitem__(self, idx):
        return self.layers[idx]

    def __len__(self):
        return len(self.layers)

    def __rshift__(self, other):
        return SequentialBlock([*self.layers, as_block(other)])

    def select_by_name(self, name: str) -> Optional[nn.Module]:
        if self.block_name == name:
            return self
        for b in self.layers:
            found = getattr(b, "select_by_name", lambda n: None)(name)
            if found is not None:
                return found
        return None


class ParallelBlock(Block):
    """Named branches over the same input -> one dict of outputs.

    Branches come as a dict by name, or as blocks (named by their
    ``block_name``). A branch with a schema sees only its schema's columns
    of a dict input; dict outputs are flattened into the result (a key
    twice raises); ``pre`` runs before the branches, ``post`` on their dict,
    then ``aggregation`` (a block or a registered name: ``"concat"``, ...)
    merges it. Without a schema of its own the block takes the union of its
    branches' where every branch has one."""

    def __init__(self, *branches, aggregation=None, pre=None, post=None, strict: bool = False,
                 block_name: Optional[str] = None, schema: Optional[Schema] = None):
        super().__init__(schema=schema, block_name=block_name)
        self.strict = strict  # kept, as the JAX package keeps it
        named: Dict[str, nn.Module] = {}
        if len(branches) == 1 and isinstance(branches[0], dict):
            named = {str(name): as_block(b) for name, b in branches[0].items()}
        else:
            if len(branches) == 1 and isinstance(branches[0], (list, tuple)):
                branches = tuple(branches[0])
            for i, b in enumerate(branches):
                b = as_block(b)
                name = getattr(b, "block_name", None) or f"branch_{i}"
                if name in named:
                    name = f"{name.lower()}_{i}"
                named[name] = b
        self.branches = nn.ModuleDict(named)
        self.aggregation = TabularAggregation.parse(aggregation)
        self.pre = _maybe_block(pre)
        self.post = _maybe_block(post)
        if self.schema is None:
            schemas = [b.schema for b in named.values() if getattr(b, "schema", None) is not None]
            if schemas and len(schemas) == len(named):
                merged = schemas[0]
                for s in schemas[1:]:
                    merged = merged + s
                self.schema = merged

    @staticmethod
    def _branch_inputs(branch, inputs):
        bschema = getattr(branch, "schema", None)
        if isinstance(inputs, dict) and bschema is not None and len(bschema):
            keep = {k: v for k, v in inputs.items() if k in bschema}
            if keep:
                return keep
        return inputs

    def forward(self, inputs, **kwargs):
        if self.pre is not None:
            inputs = call_block(self.pre, inputs, **kwargs)
        outputs: TensorDict = {}
        for name, branch in self.branches.items():
            out = call_block(branch, self._branch_inputs(branch, inputs), **kwargs)
            if isinstance(out, dict):
                for k, v in out.items():
                    if k in outputs:
                        raise ValueError(f"Duplicate output key {k!r} in ParallelBlock")
                    outputs[k] = v
            else:
                outputs[name] = out
        if self.post is not None:
            outputs = call_block(self.post, outputs, **kwargs)
        if self.aggregation is not None:
            return call_block(self.aggregation, outputs, **kwargs)
        return outputs

    def __getitem__(self, name: str) -> nn.Module:
        return self.branches[name]

    def keys(self):
        return self.branches.keys()

    def items(self):
        return self.branches.items()

    def select_by_name(self, name: str) -> Optional[nn.Module]:
        if self.block_name == name:
            return self
        if name in self.branches:
            return self.branches[name]
        for b in self.branches.values():
            found = getattr(b, "select_by_name", lambda n: None)(name)
            if found is not None:
                return found
        return None

    def select_by_tag(self, tags) -> Optional["ParallelBlock"]:
        """A ParallelBlock of the branches whose schema has a column with one
        of ``tags`` (the same blocks), or None."""
        keep = {name: b for name, b in self.branches.items()
                if getattr(b, "schema", None) is not None and len(b.schema.select_by_tag(tags))}
        if not keep:
            return None
        return ParallelBlock(keep, aggregation=self.aggregation)


class Filter(Block):
    """The entries of a dict input that a schema, names or tags select (or,
    with ``exclude``, the others); a tensor passes as it is. Tags need a
    schema first (:meth:`set_schema`)."""

    def __init__(self, selector, exclude: bool = False):
        if isinstance(selector, Schema):
            schema, names, tags = selector, set(selector.column_names), None
        elif (isinstance(selector, (list, tuple)) and selector and isinstance(selector[0], str)
              and not isinstance(selector[0], Tags)):
            schema, names, tags = None, set(selector), None
        elif isinstance(selector, str) and not isinstance(selector, Tags):
            schema, names, tags = None, {selector}, None
        else:
            tags = selector if isinstance(selector, (list, tuple)) else [selector]
            schema, names = None, None
        super().__init__(schema=schema)
        self._names = names
        self._tags = [t.value if isinstance(t, Tags) else t for t in (tags or [])] or None
        self.exclude = exclude

    def forward(self, inputs, **kwargs):
        if not isinstance(inputs, dict):
            return inputs
        if self._names is not None:
            keep = self._names
        elif self._tags is not None and self.schema is None:
            raise ValueError("Filter by tags requires set_schema() before calling")
        else:
            keep = set(self.schema.column_names)
        if self.exclude:
            return {k: v for k, v in inputs.items() if k not in keep}
        return {k: v for k, v in inputs.items() if k in keep}

    def set_schema(self, schema: Optional[Schema]) -> "Filter":
        if schema is not None and self.schema is None:
            if self._tags is not None:
                self.schema = schema.select_by_tag(self._tags)
            elif self._names is not None:
                self.schema = schema.select_by_name(sorted(self._names))
        return self


class AsTabular(Block):
    """A tensor as a one-entry dict."""

    def __init__(self, output_name: str):
        super().__init__(block_name=output_name)
        self.output_name = output_name

    def forward(self, inputs, **kwargs):
        return {self.output_name: inputs}


class ResidualBlock(Block):
    """``activation(inputs + block(inputs))`` (an activation by name)."""

    def __init__(self, block, activation=None):
        super().__init__()
        self.block = as_block(block)
        self.activation = activation

    def forward(self, inputs, **kwargs):
        from ..blocks.mlp import get_activation

        out = inputs + call_block(self.block, inputs, **kwargs)
        act = get_activation(self.activation)
        return out if act is None else act(out)


class WithShortcut(Block):
    """``{block_name_out: block(inputs), shortcut_name: inputs}``, merged by
    ``aggregation`` where one is given."""

    def __init__(self, block, shortcut_name: str = "shortcut", block_name_out: str = "output",
                 aggregation=None):
        super().__init__()
        self.block = as_block(block)
        self.shortcut_name = shortcut_name
        self.block_name_out = block_name_out
        self.aggregation = TabularAggregation.parse(aggregation)

    def forward(self, inputs, **kwargs):
        out = {self.block_name_out: call_block(self.block, inputs, **kwargs),
               self.shortcut_name: inputs}
        if self.aggregation is not None:
            return call_block(self.aggregation, out, **kwargs)
        return out


def _where_tree(pred, t, f):
    if isinstance(t, dict):
        return {k: _where_tree(pred, t[k], f[k]) for k in t}
    if isinstance(t, SequenceFeature):
        return SequenceFeature(_where_tree(pred, t.values, f.values),
                               _where_tree(pred, t.mask, f.mask))
    if isinstance(t, (tuple, list)):
        return type(t)(_where_tree(pred, a, b) for a, b in zip(t, f))
    return torch.where(pred, t, f)


class Cond(Block):
    """Both branches, chosen elementwise by ``condition(inputs)`` (the
    false branch defaults to the inputs), as the JAX package's
    ``jnp.where`` over their trees."""

    def __init__(self, condition, true_block, false_block=None):
        super().__init__()
        self.condition = condition
        self.true_block = as_block(true_block)
        self.false_block = _maybe_block(false_block)

    def forward(self, inputs, **kwargs):
        pred = call_block(self.condition, inputs, **kwargs)
        t = call_block(self.true_block, inputs, **kwargs)
        f = (call_block(self.false_block, inputs, **kwargs)
             if self.false_block is not None else inputs)
        return _where_tree(torch.as_tensor(pred), t, f)


class MapValues(Block):
    """A block applied to every value of a dict input (or to a tensor)."""

    def __init__(self, block):
        super().__init__()
        self.block = as_block(block)

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {k: call_block(self.block, v, **kwargs) for k, v in inputs.items()}
        return call_block(self.block, inputs, **kwargs)
