"""Optimizers (``models_tpu/blocks/optimizer.py`` and the ``optax`` names
``compile()`` takes).

The dense optimizers: ``adagrad`` follows optax's formula (``scale_by_rss``):
the accumulator starts at 0.1, ``acc += g * g`` and
``update = -lr * g * rsqrt(acc + 1e-7)``. ``torch.optim.Adagrad`` differs: its
accumulator starts at 0 and its eps sits outside the square root. ``sgd`` and
``adam`` (eps 1e-8) are torch's, whose formulas are optax's; on the card
Adam is ``capturable`` (its step count on the device, its bias corrections
taken there in float32, so that a training chunk can be captured as a CUDA
graph), on the CPU not (the bias corrections in Python floats). beta2 = 0.999
rounds to float32 1.3e-8 off, 1.3e-5 of ``1 - beta2`` (optax rounds it so
too): the card's updates differ from the CPU's by up to 6.4e-6 of the
update (``chip_smoke.py`` holds them to 2**-16 of it). The other names
are not ported yet (ROADMAP.md queue 1). :func:`low_precision_optimizer_state`
(``compile(optimizer_state_dtype=...)``) keeps a dense optimizer's slots in
bf16 at rest.

The row-sparse embedding optimizer (:class:`SparseEmbeddingOptimizer`,
``compile(embedding_optimizer=...)``) updates only the rows a batch looked
up, and their slots, through the row scatters of ``ops/scatter.py`` (K7, K8).
Its adagrad is not the dense one: ``acc`` starts at 0.1, the new row of
``acc`` is read before the scatter, and the update is
``-lr * g / (sqrt(acc_new) + 1e-8)``. bf16 tables take their new rows by
stochastic rounding, from noise seeded by (table, step).
"""

from __future__ import annotations

import zlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from ..inputs.embedding import SparseSlots
from ..ops.scatter import dedup_rows, row_scatter_add, row_scatter_write, stochastic_round

_NOT_PORTED = ("adamw", "rmsprop", "lamb", "adafactor")
SPARSE_KINDS = ("sgd", "adagrad", "adam")


class Adagrad(torch.optim.Optimizer):
    """optax.adagrad. Parameters without a gradient are left as they are,
    which is what a zero gradient does to them."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, eps=eps))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["sum"] = torch.full_like(p, initial_accumulator_value)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            acc = [self.state[p]["sum"] for p in params]
            torch._foreach_addcmul_(acc, grads, grads)
            scale = torch._foreach_add(acc, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_add_(params, scale, alpha=-group["lr"])


class LowPrecisionState:
    """A dense optimizer whose floating slots (Adagrad's ``sum``, Adam's
    ``exp_avg`` and ``exp_avg_sq``) are stored in ``dtype`` at rest, the JAX
    package's ``low_precision_optimizer_state``. Each step casts them up to
    float32, runs the optimizer's own float32 update on those copies (never
    in bf16), and rounds them back to nearest. Other state (Adam's ``step``)
    is left as it is. Everything but ``step`` is the wrapped optimizer's.

    The slots at rest are views of one flat tensor, so that a step casts them
    up in one copy and back in another, whatever the number of parameters.
    Slots the optimizer makes (Adam at its first step) or replaces
    (``load_state_dict``) are packed anew after the step that finds them."""

    def __init__(self, optimizer: torch.optim.Optimizer, dtype: torch.dtype):
        self.optimizer = optimizer
        self.state_dtype = dtype
        self._layout: List[tuple] = []  # (state, key, shape) of each slot, in packing order
        self._views: List[torch.Tensor] = []  # the slots as _point left them
        self._rest: Optional[torch.Tensor] = None  # the slots at rest, flat, in ``dtype``
        self._pack()

    def __getattr__(self, name):
        return getattr(self.optimizer, name)

    def _slots(self) -> List[tuple]:
        return [(state, key) for state in self.optimizer.state.values()
                for key, value in state.items()
                if key != "step" and torch.is_tensor(value) and value.is_floating_point()]

    def _point(self, flat: torch.Tensor) -> None:
        """Make every slot its view of ``flat``."""
        self._views, at = [], 0
        for state, key, shape in self._layout:
            state[key] = flat[at:at + shape.numel()].view(shape)
            self._views.append(state[key])
            at += shape.numel()

    def _packed(self) -> bool:
        """Whether the slots are still the views ``_point`` made."""
        slots = self._slots()
        return len(slots) == len(self._views) and all(
            state[key] is view for (state, key), view in zip(slots, self._views))

    def _pack(self) -> None:
        """Round the slots as they are into a new flat tensor at rest."""
        slots = self._slots()
        self._layout = [(state, key, state[key].shape) for state, key in slots]
        self._rest = torch.cat([state[key].reshape(-1).float() for state, key in slots]).to(
            self.state_dtype) if slots else None
        self._views = []
        if slots:
            self._point(self._rest)

    @torch.no_grad()
    def step(self, closure=None):
        if not self._packed():
            self._pack()
        work = None if self._rest is None else self._rest.float()
        if work is not None:
            self._point(work)
        out = self.optimizer.step(closure)
        if work is not None and self._packed():
            self._rest.copy_(work)  # rounds to nearest
            self._point(self._rest)
        else:
            self._pack()
        return out


def low_precision_optimizer_state(optimizer: torch.optim.Optimizer,
                                  dtype: Union[str, torch.dtype] = torch.bfloat16
                                  ) -> LowPrecisionState:
    """``optimizer`` with its slots stored in ``dtype`` (a torch dtype or its
    name, e.g. ``"bfloat16"``): :class:`LowPrecisionState`. bf16 keeps about
    8 bits of mantissa, so a monotone accumulator (adagrad's sum of squares,
    adam's second moment) drops relative increments below about 2**-8."""
    return LowPrecisionState(optimizer, state_dtype(dtype))


def state_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """The floating torch dtype ``dtype`` names; raises for any other."""
    resolved = getattr(torch, dtype, None) if isinstance(dtype, str) else dtype
    if not isinstance(resolved, torch.dtype) or not resolved.is_floating_point:
        raise ValueError(f"optimizer_state_dtype must be a floating dtype, not {dtype!r}")
    return resolved


def check_optimizer(name: str) -> None:
    """Raise unless ``name`` is a ported optimizer."""
    if name in ("adagrad", "sgd", "adam"):
        return
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP.md queue 1); ported: adagrad, "
            "sgd, adam")
    raise ValueError(f"Unknown optimizer {name!r}")


class NoParameters:
    """The dense optimizer of a model whose every parameter trains
    row-sparsely (a matrix factorization under ``embedding_optimizer``):
    nothing to step, as optax steps an empty tree."""

    state: dict = {}
    param_groups: list = []

    def zero_grad(self, set_to_none: bool = True) -> None:
        pass

    def step(self, closure=None) -> None:
        pass


def make_optimizer(name: str, params: Iterable[torch.Tensor],
                   learning_rate: Optional[float]) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` (:class:`NoParameters` where
    there are none); the learning rate defaults to 1e-3, as in the JAX
    package."""
    check_optimizer(name)
    lr = 1e-3 if learning_rate is None else float(learning_rate)
    params = list(params)
    if not params:
        return NoParameters()
    if name == "adagrad":
        return Adagrad(params, lr)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr)
    return torch.optim.Adam(params, lr=lr, eps=1e-8,
                            capturable=any(p.device.type == "cuda" for p in params))


# ---------------------------------------------------------------------------
# the row-sparse embedding optimizer
# ---------------------------------------------------------------------------


def _table_salt(table) -> int:
    """A table's stochastic-rounding salt: the crc32 of its name, the same in
    every process."""
    name = getattr(table, "block_name", None) or "table"
    return zlib.crc32(str(name).encode()) & 0x7FFFFFFF


def draw_noise(shape, salt: int, step: int, device) -> torch.Tensor:
    """Stochastic-rounding noise for one table update: int32 in [0, 2**16)
    from a ``torch.Generator`` on ``device`` seeded by (salt, step), so that a
    replay rounds alike. CPU and CUDA generators give different bits."""
    gen = torch.Generator(device).manual_seed((salt << 32) | int(step))
    return torch.randint(0, 1 << 16, tuple(shape), generator=gen, device=device,
                         dtype=torch.int32)


def _commit_rows(tbl, sids, delta, valid, step, salt, noise):
    """Add per-row deltas to a table: an fp32 table in place by the row
    scatter-add (K7); a bf16 table takes ``old + delta`` in fp32, rounded
    stochastically (``noise`` draws the bits), through the row scatter-write
    (K8)."""
    if tbl.dtype == torch.float32:
        return row_scatter_add(tbl, sids, delta, valid)
    new = tbl.index_select(0, sids).float() + delta
    rows = stochastic_round(new, noise(new.shape, salt, step, new.device))
    return row_scatter_write(tbl, sids, rows, valid)


class SparseEmbeddingOptimizer:
    """Updates embedding tables from (ids, row gradients) pairs.

    ``kind``: ``"sgd"``, ``"adagrad"`` or ``"adam"`` (LazyAdam: the slots
    move only at touched rows; bias correction takes the global step).
    ``learning_rate`` is a float or a function of the step. ``noise`` draws
    the stochastic-rounding bits of bf16 tables (:func:`draw_noise`); a caller
    that compares two devices gives both the same."""

    def __init__(self, kind: str = "adagrad",
                 learning_rate: Union[float, Callable[[int], float]] = 0.05,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 initial_accumulator_value: float = 0.1):
        if kind not in SPARSE_KINDS:
            raise ValueError(f"Unknown sparse optimizer {kind!r}; ported: sgd, adagrad, adam "
                             "(also as lazy_adam, sparse_adagrad, ...)")
        self.kind = kind
        self.learning_rate = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.init_acc = initial_accumulator_value
        self.noise = draw_noise

    def slot_names(self) -> Tuple[str, ...]:
        return {"adagrad": ("acc",), "adam": ("m", "v")}.get(self.kind, ())

    def init_slots(self, table) -> None:
        """Give ``table`` fresh float32 slots of its shape."""
        like = dict(size=table.table.shape, dtype=torch.float32, device=table.table.device)
        if self.kind == "adagrad":
            slots = {"acc": torch.full(fill_value=self.init_acc, **like)}
        else:
            slots = {name: torch.zeros(**like) for name in self.slot_names()}
        table.sparse_slots = SparseSlots(slots)

    @torch.no_grad()
    def apply(self, table, ids: torch.Tensor, grads: torch.Tensor, step: int) -> None:
        """Update ``table`` and its slots at the looked-up rows. ``ids``
        (...,) of any integer type, ``grads`` (..., D): each lookup's row
        gradient. Equal ids are summed first, so each row takes one update
        from its summed gradient, as a dense gradient would give it."""
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_g = grads.reshape(-1, grads.shape[-1]).float()
        sids, gsum, valid = dedup_rows(flat_ids, flat_g)
        lr = self.learning_rate(step) if callable(self.learning_rate) else self.learning_rate
        salt = _table_salt(table)

        def commit(delta):
            _commit_rows(table.table, sids, delta, valid, step, salt, self.noise)

        if self.kind == "sgd":
            return commit(-lr * gsum)
        if self.kind == "adagrad":
            acc = table.sparse_slots["acc"]
            g2 = gsum * gsum
            acc_new_rows = acc.index_select(0, sids) + g2
            row_scatter_add(acc, sids, g2, valid)
            return commit(-lr * gsum / (torch.sqrt(acc_new_rows) + self.eps))
        m, v = table.sparse_slots["m"], table.sparse_slots["v"]
        b1, b2 = self.beta1, self.beta2
        m_old, v_old = m.index_select(0, sids), v.index_select(0, sids)
        m_new = b1 * m_old + (1 - b1) * gsum
        v_new = b2 * v_old + (1 - b2) * gsum * gsum
        row_scatter_add(m, sids, m_new - m_old, valid)
        row_scatter_add(v, sids, v_new - v_old, valid)
        # the bias corrections in float32, as the JAX package computes them:
        # 1 - 0.999**t cancels, and float64 would differ from it by up to 2e-5
        f32 = dict(dtype=torch.float32)
        t = torch.tensor(max(float(step) + 1.0, 1.0), **f32)
        c1 = float(1 - torch.tensor(b1, **f32) ** t)
        c2 = float(1 - torch.tensor(b2, **f32) ** t)
        mhat = m_new / c1
        vhat = v_new / c2
        return commit(-lr * mhat / (torch.sqrt(vhat) + self.eps))


def LazyAdam(learning_rate: float = 0.001, beta1: float = 0.9, beta2: float = 0.999,
             eps: float = 1e-8) -> SparseEmbeddingOptimizer:
    """Sparse Adam that updates only the looked-up rows."""
    return SparseEmbeddingOptimizer("adam", learning_rate, beta1, beta2, eps)


def split_embeddings_on_size(tables: Sequence, threshold: int) -> Tuple[List, List]:
    """(large, small): the tables with more rows than ``threshold``, and the rest."""
    large = [t for t in tables if t.input_dim > threshold]
    small = [t for t in tables if t.input_dim <= threshold]
    return large, small
