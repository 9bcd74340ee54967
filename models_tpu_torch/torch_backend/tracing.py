"""Schema trace / select / extract machinery for the torch DSL
(``models_tpu/torch_backend/tracing.py``).

Reference: ``merlin/models/torch/schema.py`` — ``trace`` (:228, hook-based
per-module schema recording), ``select``/``_SelectDispatch`` (:194),
``extract``/``_ExtractDispatch`` (:207), ``select_schema`` (:391),
``select_union`` (:446), ``selection_name`` (:475), ``Selectable`` (:507).

Rebuilt hook-based and dispatch-free: :func:`trace` runs ONE forward pass
with ``register_forward_hook`` on every submodule and records input/output
schemas inferred from the live tensors (the reference wraps the same hook
trick in lazy single-dispatchers). :func:`select` / :func:`extract` operate
structurally on the DSL containers (ParallelBlock branches, Block chains,
EmbeddingTable columns) and SHARE parameters with the original module — the
selected tower serves with the trained weights, exactly like the reference's
``select(model, Tags.USER)``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..schema import ColumnSchema, Schema, Tags
from .dsl import Batch, Block, EmbeddingTable, ParallelBlock, SelectKeys, _call

Selection = Union[Schema, ColumnSchema, Tags, str, list, tuple, Callable]

_TORCH_DTYPES = {
    torch.float32: "float32", torch.float64: "float64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.bool: "bool",
}


# ---------------------------------------------------------------------------
# selections over schemas (reference schema.py:391-505)
# ---------------------------------------------------------------------------

def select_schema(schema: Schema, selection: Selection) -> Schema:
    """Narrow ``schema`` by a selection: a Schema (intersection by name), a
    ColumnSchema / column name, a Tags value, a list of names/tags, or a
    callable ``Schema -> Schema`` (reference ``select_schema:391``)."""
    if selection is None:
        return schema
    if isinstance(selection, Schema):
        names = set(selection.column_names)
        return schema.select_by_name([n for n in schema.column_names if n in names])
    if isinstance(selection, ColumnSchema):
        return schema.select_by_name(
            [selection.name] if selection.name in schema else []
        )
    if callable(selection) and not isinstance(selection, (Tags, type)):
        out = selection(schema)
        if not isinstance(out, Schema):
            raise ValueError(f"callable selection must return a Schema, got {out!r}")
        return out
    if isinstance(selection, (list, tuple, set)):
        cols: Dict[str, ColumnSchema] = {}
        for sel in selection:
            for col in select_schema(schema, sel):
                cols[col.name] = col
        return Schema([cols[n] for n in schema.column_names if n in cols])
    if isinstance(selection, Tags):
        return schema.select_by_tag(selection)
    if isinstance(selection, str):
        # a column name, else a tag string
        if selection in schema:
            return schema.select_by_name([selection])
        return schema.select_by_tag(selection)
    raise ValueError(f"unsupported selection: {selection!r}")


def select_union(*selections: Selection) -> Callable[[Schema], Schema]:
    """Combine selections into one callable selection (reference ``:446``)."""

    def combined(schema: Schema) -> Schema:
        return select_schema(schema, list(selections))

    return combined


def selection_name(selection: Selection) -> str:
    """Human/branch name for a selection (reference ``:475``)."""
    if isinstance(selection, ColumnSchema):
        return selection.name
    if isinstance(selection, Tags):
        return selection.value
    if isinstance(selection, Schema):
        return "_".join(selection.column_names)
    if isinstance(selection, (list, tuple, set)):
        return "_".join(selection_name(s) for s in selection)
    if callable(selection):
        return getattr(selection, "__name__", "selection")
    return str(selection)


class Selectable:
    """Protocol mixin: a module that knows how to narrow itself to a feature
    selection (reference ``Selectable:507``). Containers defined here handle
    the DSL types structurally; custom modules subclass this and override
    :meth:`select`."""

    def select(self, selection: Selection) -> "nn.Module":
        raise NotImplementedError(
            f"{type(self).__name__} must implement select(selection)"
        )


# ---------------------------------------------------------------------------
# trace: one hooked forward pass records per-module input/output schemas
# (reference schema.py:228-296)
# ---------------------------------------------------------------------------

def _tensors_to_schema(obj, default_name: str = "output") -> Schema:
    """Schema inferred from live tensors: dict keys become column names;
    a lone tensor becomes ``default_name`` (reference ``_tensor_to_schema:556``).
    3-D float tensors and 2-D int tensors are tagged LIST (padded sequences)."""
    cols = []

    def _col(name, t):
        if isinstance(t, torch.Tensor):
            dtype = _TORCH_DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))
            tags = set()
            if t.dim() >= 3 or (t.dim() == 2 and not t.is_floating_point()):
                tags.add(Tags.LIST.value)
            if not t.is_floating_point():
                tags.add(Tags.CATEGORICAL.value)
            else:
                tags.add(Tags.CONTINUOUS.value)
            is_list = Tags.LIST.value in tags
            vc = (t.shape[-1], t.shape[-1]) if is_list and t.dim() >= 2 else None
            cols.append(ColumnSchema(name, tags=tuple(sorted(tags)), dtype=dtype,
                                     is_list=is_list, value_count=vc))
        elif hasattr(t, "values") and hasattr(t, "mask"):  # SequenceFeature
            _col(name, t.values)

    if isinstance(obj, dict):
        for k in sorted(obj):
            _col(str(k), obj[k])
    elif isinstance(obj, (list, tuple)):
        for i, t in enumerate(obj):
            _col(f"{default_name}_{i}" if i else default_name, t)
    else:
        _col(default_name, obj)
    return Schema(cols)


def trace(module: nn.Module, inputs, batch: Optional[Batch] = None):
    """Run ``module(inputs, batch=batch)`` once with forward hooks on every
    submodule, recording ``__input_schema__`` / ``__output_schema__`` on each
    (reference ``trace:228``). Returns the forward output; afterwards
    :func:`input_schema` / :func:`output_schema` answer for ANY submodule."""
    handles = []

    def _hook(mod, args, output):
        x = args[0] if args else None
        mod.__input_schema__ = _tensors_to_schema(x)
        mod.__output_schema__ = _tensors_to_schema(output)

    for m in module.modules():
        handles.append(m.register_forward_hook(_hook))
    dev = next((p.device for p in module.parameters()), None)
    try:
        if isinstance(inputs, dict):
            inputs = {
                k: (torch.as_tensor(v, device=dev) if not isinstance(v, torch.Tensor)
                    and not hasattr(v, "values") else v)
                for k, v in inputs.items()
            }
        with torch.no_grad():
            out = _call(module, inputs, batch)
    finally:
        for h in handles:
            h.remove()
    return out


def input_schema(module: nn.Module) -> Schema:
    """Input schema of a module: traced (``__input_schema__`` from
    :func:`trace`) first, declared ``.schema`` second (reference
    ``input_schema`` dispatch, schema.py:86-124)."""
    traced = getattr(module, "__input_schema__", None)
    if traced is not None:
        return traced
    declared = getattr(module, "schema", None)
    if isinstance(declared, Schema):
        return declared
    raise ValueError(
        f"{type(module).__name__} has no input schema — trace() it first or "
        "attach .schema"
    )


def output_schema(module: nn.Module) -> Schema:
    """Output schema of a module: traced first, else derived from declared
    heads (reference ``output_schema`` dispatch, schema.py:126-192)."""
    traced = getattr(module, "__output_schema__", None)
    if traced is not None:
        return traced
    declared = getattr(module, "schema", None)
    if isinstance(declared, Schema):
        targets = declared.targets
        if len(targets):
            return targets
    raise ValueError(
        f"{type(module).__name__} has no output schema — trace() it first"
    )


def feature_schema(module: nn.Module) -> Schema:
    """Raw feature columns the module consumes (reference ``:297``)."""
    return input_schema(module).excluding_by_tag(Tags.TARGET)


def target_schema(module: nn.Module) -> Schema:
    """Target columns declared on the module's schema (reference ``:329``)."""
    declared = getattr(module, "schema", None)
    if isinstance(declared, Schema):
        return declared.targets
    return input_schema(module).targets


# ---------------------------------------------------------------------------
# feature schema of a module (what raw columns it consumes) — used by select
# ---------------------------------------------------------------------------

def _consumed_schema(module: nn.Module) -> Optional[Schema]:
    """The raw feature columns a module (sub)graph reads, from its structure:
    SelectKeys filters, EmbeddingTable columns, declared schemas."""
    if isinstance(module, SelectKeys):
        return module.schema
    if isinstance(module, EmbeddingTable):
        return Schema(module.cols)
    declared = getattr(module, "schema", None)
    if isinstance(declared, Schema):
        return declared
    schemas = []
    for child in module.children():
        s = _consumed_schema(child)
        if s is not None:
            schemas.append(s)
    if not schemas:
        return None
    cols: Dict[str, ColumnSchema] = {}
    for s in schemas:
        for c in s:
            cols.setdefault(c.name, c)
    return Schema(list(cols.values()))


# ---------------------------------------------------------------------------
# select / extract (reference schema.py:194-226)
# ---------------------------------------------------------------------------

def select(module: nn.Module, selection: Selection) -> nn.Module:
    """The sub-module that processes ONLY the selected features, sharing
    parameters with ``module`` (reference ``select:194``): the canonical use
    is pulling a trained tower out of a two-branch model —
    ``user_tower = select(model, Tags.USER)``.

    Raises ``ValueError`` when nothing in the module consumes the selection.
    """
    out = _try_select(module, selection)
    if out is None:
        raise ValueError(
            f"selection {selection_name(selection)!r} matches nothing in "
            f"{type(module).__name__}"
        )
    return out


def _try_select(module: nn.Module, selection: Selection) -> Optional[nn.Module]:
    if isinstance(module, Selectable):
        try:
            return module.select(selection)
        except NotImplementedError:
            pass
    if isinstance(module, SelectKeys):
        narrowed = select_schema(module.schema, selection)
        return SelectKeys(narrowed) if len(narrowed) else None
    if isinstance(module, EmbeddingTable):
        keep = [c for c in module.cols
                if c.name in select_schema(Schema(module.cols), selection)]
        if not keep:
            return None
        new = EmbeddingTable.__new__(EmbeddingTable)
        nn.Module.__init__(new)
        new.cols, new.dim, new.seq_combiner = keep, module.dim, module.seq_combiner
        new.table = module.table  # SHARED weights
        return new
    if isinstance(module, ParallelBlock):
        kept: Dict[str, nn.Module] = {}
        for name, branch in module.branches.items():
            sub = _try_select(branch, selection)
            if sub is not None:
                kept[name] = sub
        if not kept:
            return None
        if len(kept) == len(module.branches) and all(
            kept[n] is module.branches[n] for n in kept
        ):
            return module
        out = ParallelBlock(kept, agg=module.agg)
        declared = getattr(module, "schema", None)
        if isinstance(declared, Schema):
            out.schema = select_schema(declared, selection)
        return out
    if isinstance(module, Block):
        if not len(module.values):
            return None
        head = _try_select(module.values[0], selection)
        if head is None:
            return None
        if head is module.values[0]:
            return module
        return Block(head, *list(module.values)[1:])
    # leaf: matches iff its consumed features intersect the selection fully
    consumed = _consumed_schema(module)
    if consumed is not None:
        narrowed = select_schema(consumed, selection)
        if len(narrowed) == 0:
            return None
        return module
    return None


def extract(module: nn.Module, selection: Selection) -> Tuple[nn.Module, nn.Module]:
    """Split ``module`` into (remainder, route): the route is the sub-module
    consuming the selection (as :func:`select`), the remainder is the module
    with that route removed (reference ``extract:207``). Parameters stay
    shared with the original."""
    route = select(module, selection)
    remainder = _remove(module, selection)
    if remainder is None:
        raise ValueError(
            f"extracting {selection_name(selection)!r} leaves nothing in "
            f"{type(module).__name__}"
        )
    return remainder, route


def _remove(module: nn.Module, selection: Selection) -> Optional[nn.Module]:
    """The complement of _try_select: drop branches fully consumed by the
    selection; None when nothing remains."""
    if isinstance(module, ParallelBlock):
        kept: Dict[str, nn.Module] = {}
        for name, branch in module.branches.items():
            consumed = _consumed_schema(branch)
            if consumed is not None and len(consumed):
                narrowed = select_schema(consumed, selection)
                if len(narrowed) == len(consumed):
                    continue  # fully selected → removed
                if len(narrowed) == 0:
                    kept[name] = branch
                    continue
            sub = _remove(branch, selection)
            if sub is not None:
                kept[name] = sub
        if not kept:
            return None
        out = ParallelBlock(kept, agg=module.agg)
        declared = getattr(module, "schema", None)
        if isinstance(declared, Schema):
            out.schema = declared.excluding_by_name(
                select_schema(declared, selection).column_names
            ) if hasattr(declared, "excluding_by_name") else declared
        return out
    if isinstance(module, Block):
        if not len(module.values):
            return None
        head = _remove(module.values[0], selection)
        if head is None:
            return None
        if head is module.values[0]:
            return module
        return Block(head, *list(module.values)[1:])
    if isinstance(module, SelectKeys):
        narrowed = select_schema(module.schema, selection)
        remaining = [c for c in module.schema if c.name not in narrowed.column_names]
        return SelectKeys(Schema(remaining)) if remaining else None
    if isinstance(module, EmbeddingTable):
        selected = select_schema(Schema(module.cols), selection)
        keep = [c for c in module.cols if c.name not in selected.column_names]
        if not keep:
            return None
        if len(keep) == len(module.cols):
            return module
        new = EmbeddingTable.__new__(EmbeddingTable)
        nn.Module.__init__(new)
        new.cols, new.dim, new.seq_combiner = keep, module.dim, module.seq_combiner
        new.table = module.table
        return new
    consumed = _consumed_schema(module)
    if consumed is not None and len(consumed):
        narrowed = select_schema(consumed, selection)
        if len(narrowed) == len(consumed):
            return None
    return module
