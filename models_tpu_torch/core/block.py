"""Block: the composable unit of the port (``models_tpu/core/block.py``).

A Block is a ``torch.nn.Module`` that may carry a ``schema``; combinators use it
to route each branch only the columns it declares. ``forward`` takes a tensor or
a ``Dict[str, tensor | SequenceFeature]`` and keyword arguments it may ignore
(:func:`call_block` passes a callable only the ones it declares).

Blocks compose as the JAX package's do: ``a >> b`` (and ``connect``) is a
:class:`~models_tpu_torch.core.combinators.SequentialBlock`,
``connect_branch`` / ``repeat_in_parallel`` a ``ParallelBlock``,
``connect_with_residual`` / ``connect_with_shortcut`` a ``ResidualBlock`` /
``WithShortcut``, and ``repeat`` stacks fresh copies (:func:`fresh_copy`).
Widths need not be given: the layers that need one build at the model's
build pass (``blocks/mlp.py::LazyMixin``).
"""

from __future__ import annotations

import copy
import functools
import inspect
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..registry import block_registry
from ..schema import Schema
from .config import copy_captures, record_init

_CALL_KWARGS_CACHE: Dict[Any, Any] = {}


def call_block(block, inputs, **kwargs):
    """Call a block or a function with only the keyword arguments its
    signature accepts (all of them where it takes ``**kwargs``)."""
    fn = block.forward if isinstance(block, nn.Module) else block
    key = type(block) if isinstance(block, nn.Module) else block
    accepted = _CALL_KWARGS_CACHE.get(key)
    if accepted is None:
        try:
            params = inspect.signature(fn).parameters.values()
            if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params):
                accepted = True
            else:
                accepted = frozenset(p.name for p in params
                                     if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD))
        except (TypeError, ValueError):
            accepted = frozenset()
        _CALL_KWARGS_CACHE[key] = accepted
    if accepted is not True:
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
    return block(inputs, **kwargs)


class Block(nn.Module):
    """Every subclass's constructor call is recorded
    (:func:`~models_tpu_torch.core.config.record_init`, the outermost call
    of an object), so that a model saves as a config tree
    (``core/config.py``); a deep copy carries its records, its blocks mapped
    to their copies."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        orig = cls.__dict__.get("__init__")
        if orig is not None and not getattr(orig, "_records_config", False):
            @functools.wraps(orig)
            def wrapped(self, *args, __orig=orig, **kwargs):
                record_init(self, args, kwargs)
                __orig(self, *args, **kwargs)

            wrapped._records_config = True
            cls.__init__ = wrapped

    def __init__(self, schema: Optional[Schema] = None, block_name: Optional[str] = None):
        record_init(self, (), {"schema": schema, "block_name": block_name})
        super().__init__()
        self.schema = schema
        self.block_name = block_name or type(self).__name__

    def __deepcopy__(self, memo):
        # nn.Module's own deep copy (its __reduce_ex__ state through
        # __setstate__), plus the config records
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(copy.deepcopy(self.__dict__, memo))
        copy_captures(self, new, memo)
        return new

    def forward(self, inputs, **kwargs):  # pragma: no cover - overridden
        raise NotImplementedError

    def set_schema(self, schema: Optional[Schema]) -> "Block":
        if schema is not None and getattr(self, "schema", None) is None:
            self.schema = schema
        return self

    # ---- composition ---------------------------------------------------
    def __rshift__(self, other) -> "Block":
        from .combinators import SequentialBlock

        return SequentialBlock([self, other])

    def __rrshift__(self, other) -> "Block":
        from .combinators import SequentialBlock

        return SequentialBlock([other, self])

    def connect(self, *blocks) -> "Block":
        from .combinators import SequentialBlock

        return SequentialBlock([self, *blocks])

    def connect_branch(self, *branches, add_rest: bool = False, aggregation=None) -> "Block":
        from .combinators import ParallelBlock, SequentialBlock

        return SequentialBlock([self, ParallelBlock(list(branches), aggregation=aggregation)])

    def connect_with_residual(self, block, activation=None) -> "Block":
        from .combinators import ResidualBlock, SequentialBlock

        return SequentialBlock([self, ResidualBlock(block, activation=activation)])

    def connect_with_shortcut(self, block, shortcut_filter=None, aggregation="concat") -> "Block":
        from .combinators import SequentialBlock, WithShortcut

        return SequentialBlock([self, WithShortcut(block, aggregation=aggregation)])

    def repeat(self, num: int) -> "Block":
        """This block and ``num - 1`` fresh copies of it (salts 1, 2, ...)
        in sequence."""
        from .combinators import SequentialBlock

        return SequentialBlock([self] + [fresh_copy(self, i) for i in range(1, num)])

    def repeat_in_parallel(self, num: int, prefix: str = "branch", aggregation=None) -> "Block":
        from .combinators import ParallelBlock

        return ParallelBlock({f"{prefix}_{i}": self if i == 0 else fresh_copy(self, i)
                              for i in range(num)}, aggregation=aggregation)

    def as_model(self):
        from ..models.base import Model

        return Model(self)

    def select_by_name(self, name: str) -> Optional["Block"]:
        return self if self.block_name == name else None


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


@block_registry.register("no-op")
class NoOp(Block):
    """Identity."""

    def forward(self, inputs, **kwargs):
        return inputs


class Lambda(Block):
    """A function as a block; it is called with the keyword arguments it
    declares (:func:`call_block`)."""

    def __init__(self, fn: Callable, block_name: Optional[str] = None):
        super().__init__(block_name=block_name or getattr(fn, "__name__", "lambda"))
        self.fn = fn

    def forward(self, inputs, **kwargs):
        return call_block(self.fn, inputs, **kwargs)


class Debug(Block):
    """Pass-through, a place to stop in a debugger."""

    def forward(self, inputs, **kwargs):
        return inputs


def iter_blocks(root: nn.Module):
    """The block graph depth first, the root first, each module once."""
    yield from root.modules()


def as_block(obj) -> nn.Module:
    """A block from a block (or any ``nn.Module``), a registered name, or a
    function (a :class:`Lambda`)."""
    if isinstance(obj, nn.Module):
        return obj
    if isinstance(obj, str):
        return block_registry.parse(obj)
    if callable(obj):
        return Lambda(obj)
    raise TypeError(f"Cannot convert {obj!r} to a Block")


def fresh_copy(block, salt: int) -> nn.Module:
    """A deep copy of ``block`` (or of what :func:`as_block` makes of it)
    with its weights drawn anew, each from a generator seeded by ``7919 *
    salt`` and its position: embedding tables truncated-normal (sigma 0.05,
    as made), other weights of two or more dimensions (Dense kernels)
    glorot-uniform; biases and norms kept. A layer not built yet takes the
    JAX package's rule instead: its ``seed`` moves by ``7919 * salt``, so
    that it draws anew at its build. The draws differ from the JAX
    package's, as every draw of the two packages does. Used where one block
    would otherwise serve twice: ``Block.repeat``, both towers of a
    two-tower model, the experts of a group (``blocks/experts.py``), a tower
    cloned for each task (``outputs/tasks.py::PredictionTasks``)."""
    cp = copy.deepcopy(as_block(block))
    for m in cp.modules():
        if (hasattr(m, "built") and not m.built and isinstance(getattr(m, "seed", None), int)):
            m.seed = m.seed + 7919 * salt
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
