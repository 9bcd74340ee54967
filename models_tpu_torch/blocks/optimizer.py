"""Optimizers (``models_tpu/blocks/optimizer.py`` and the ``optax`` names
``compile()`` takes).

The dense optimizers: ``adagrad`` follows optax's formula (``scale_by_rss``):
the accumulator starts at 0.1, ``acc += g * g`` and
``update = -lr * g * rsqrt(acc + 1e-7)``. ``torch.optim.Adagrad`` differs: its
accumulator starts at 0 and its eps sits outside the square root. ``sgd`` is
``update = -lr * g``. ``adam`` (eps 1e-8) with a number for its rate is
torch's, whose formula is optax's; on the card Adam is ``capturable`` (its
step count on the device, its bias corrections taken there in float32, so
that a training chunk can be captured as a CUDA graph), on the CPU not (the
bias corrections in Python floats). beta2 = 0.999 rounds to float32 1.3e-8
off, 1.3e-5 of ``1 - beta2`` (optax rounds it so too): the card's updates
differ from the CPU's by up to 6.4e-6 of the update (``chip_smoke.py`` holds
them to 2**-16 of it).

``adamw``, ``rmsprop``, ``lamb`` and ``adafactor`` are written out to optax
0.2.6's chains with its defaults (:class:`AdamW`, :class:`RMSprop`,
:class:`Lamb`, :class:`Adafactor`); torch's own differ (``RMSprop``'s decay
0.99 and its eps outside the root; ``AdamW``'s decay folded into the
parameter first). Each keeps its step count on the parameter's device, so
that a captured chunk replays its bias corrections and schedules, and steps
every parameter, one without a gradient as with a zero one, as optax does.
Their ``learning_rate`` may be a function of the step count (an int32
tensor, 0 at the first step) giving the rate; adagrad and sgd take one too
(:class:`Adagrad` and :class:`SGD` then keep that count on the device), and
adam takes one as :class:`Adam` (AdamW's chain without the decay: optax's
adam term for term). :func:`low_precision_optimizer_state`
(``compile(optimizer_state_dtype=...)``) keeps a dense optimizer's slots in
bf16 at rest. :class:`MultiOptimizer` sends parameters to different
optimizers by rule.

The dense adagrad and sgd step an embedding table whose gradient is +0 at
every row its step did not look up at the looked-up rows alone (the row
route, :class:`_Foreach`): the same ``_foreach`` arithmetic on the gathered
rows, the same result bit for bit, without rewriting every row of the table
and its slot. ``Model.train_step`` chooses the tables (``models/base.py``;
:func:`row_route_params` says which parameters may take it). Adam
and the chains are never routed: their moments, or their decay, move at a
zero gradient. Nor is a :class:`LowPrecisionState`, or a mesh.

The row-sparse embedding optimizer (:class:`SparseEmbeddingOptimizer`,
``compile(embedding_optimizer=...)``) updates only the rows a batch looked
up, and their slots, through the row scatters of ``ops/scatter.py`` (K7, K8).
Its adagrad is not the dense one: ``acc`` starts at 0.1, the new row of
``acc`` is read before the scatter, and the update is
``-lr * g / (sqrt(acc_new) + 1e-8)``. bf16 tables take their new rows by
stochastic rounding, from noise seeded by (table, step).
"""

from __future__ import annotations

import re
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

from ..inputs.embedding import SparseSlots
from ..ops.embedding_lookup import row_gather
from ..ops.scatter import (dedup_rows, row_scatter_add, row_scatter_write, run_starts,
                           stochastic_round)

DENSE_OPTIMIZERS = ("adagrad", "adam", "adamw", "adafactor", "lamb", "rmsprop", "sgd")
SPARSE_KINDS = ("sgd", "adagrad", "adam")


class _Foreach(torch.optim.Optimizer):
    """Base of adagrad and sgd: one update for all of a group's parameters
    in a few multi-tensor (``_foreach``) calls. Parameters without a
    gradient are left as they are, which is what a zero gradient does to
    them. ``lr``: a number, or a function of the step count giving the rate
    (optax's schedule), evaluated inside the step from an int32 ``step`` that
    each parameter then keeps on its device, so that a captured chunk
    replays the schedule. Only a schedule reads the count, so only a
    schedule keeps it.

    The row route: ``step(lookups=)`` names, for some of the parameters
    (float32 (R, D) tables), the ids the step looked up in them. Such a
    table is stepped at those rows alone: the ids sorted, the first of each
    run marked, its rows, its slots' rows and its gradient's rows gathered
    (K9), the same ``_foreach`` calls run on those (N, D) rows beside the
    group's other parameters, and the table's and slots' rows written back
    (K8a). Where the caller has made sure that the gradient is +0 at every
    other row, as ``F.embedding``'s backward leaves it, this is the dense
    step bit for bit: there the dense step stores what is already there
    (``acc + 0 * 0 = acc``; ``rsqrt(acc + 1e-7) * 0 = 0``, ``acc`` at least
    0.1; ``p + 0 * -lr = p`` for a rate at least 0, since ``x + -0 = x``
    for every x, ±0 too), and at the looked-up rows the same elementwise
    kernels see the same values. The rate, the schedule and its count are
    the dense step's."""

    # the per-row slots a step moves (gathered and written back on the row route)
    slots: Tuple[str, ...] = ()

    def __init__(self, params: Iterable[torch.Tensor], lr):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                if callable(lr):
                    state["step"] = torch.zeros((), dtype=torch.int32, device=p.device)
                self._init_slots(p, state)

    def _init_slots(self, p: torch.Tensor, state: dict) -> None:
        pass

    def _direction(self, states: list, grads: list) -> list:
        """The update before the rate: new tensors (the slots of ``states``,
        one dict a parameter, moved in place)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None,
             lookups: Optional[Dict[torch.Tensor, List[torch.Tensor]]] = None):
        """One update of every parameter with a gradient; ``lookups``: the
        row route's tables, each with the ids its step looked up (the
        class's note)."""
        lookups = lookups or {}
        for group in self.param_groups:
            lr, rate = group["lr"], None
            if callable(lr):
                steps = [self.state[p]["step"] for p in group["params"]]
                rate = -lr(steps[0])  # optax: updates * -lr(count)
                torch._foreach_add_(steps, 1)
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            targets, states, grads, writes = [], [], [], []
            for p in params:
                ids = lookups.get(p)
                if ids is None:
                    targets.append(p)
                    states.append(self.state[p])
                    grads.append(p.grad)
                    continue
                sids, first = looked_up_rows(ids)
                rows = {k: row_gather(self.state[p][k], sids) for k in self.slots}
                targets.append(row_gather(p, sids))
                states.append(rows)
                grads.append(row_gather(p.grad, sids))
                writes.append((p, rows, targets[-1], sids, first))
            u = self._direction(states, grads)
            if rate is None:
                torch._foreach_add_(targets, u, alpha=-lr)
            else:
                torch._foreach_add_(targets, torch._foreach_mul(u, rate))
            for p, rows, new, sids, first in writes:
                row_scatter_write(p, sids, new, first)
                for k in self.slots:
                    row_scatter_write(self.state[p][k], sids, rows[k], first)


def looked_up_rows(ids: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ids of a table's lookups sorted, int32 (N,); True at the first
    position of each run of equal ids (N,)), N the lookups' ids in all: no
    shape depends on the data."""
    flat = torch.cat([i.reshape(-1) for i in ids]) if len(ids) > 1 else ids[0].reshape(-1)
    sids = torch.sort(flat.to(torch.int32)).values
    return sids, run_starts(sids)


class Adagrad(_Foreach):
    """optax.adagrad: the accumulator from 0.1, ``acc += g * g``, the update
    ``rsqrt(acc + 1e-7) * g * -lr``."""

    slots = ("sum",)

    def _init_slots(self, p, state):
        state["sum"] = torch.full_like(p, 0.1)

    def _direction(self, states, grads):
        acc = [st["sum"] for st in states]
        torch._foreach_addcmul_(acc, grads, grads)
        scale = torch._foreach_add(acc, 1e-7)
        torch._foreach_rsqrt_(scale)
        torch._foreach_mul_(scale, grads)
        return scale


class SGD(_Foreach):
    """optax.sgd: the update ``g * -lr``."""

    def _direction(self, states, grads):
        return grads


def row_route_params(optimizer) -> set:
    """The parameters the row route may step: the float32 ones of an
    :class:`Adagrad` or :class:`SGD`, alone or in a :class:`MultiStep`.
    None of Adam's (its moments move at a zero gradient), nor under
    :class:`LowPrecisionState` (whose up-cast of the slots stays
    table-sized)."""
    opts = optimizer.optimizers.values() if isinstance(optimizer, MultiStep) else [optimizer]
    return {p for opt in opts if isinstance(opt, _Foreach)
            for group in opt.param_groups for p in group["params"] if p.dtype == torch.float32}


# optax 0.2.6's defaults of the chains below, the only values the JAX
# package's ``compile()`` reaches
ADAM_B1, ADAM_B2 = 0.9, 0.999
ADAMW_EPS, ADAMW_WEIGHT_DECAY = 1e-8, 1e-4
LAMB_EPS = 1e-6  # lamb's weight decay is 0
RMSPROP_DECAY, RMSPROP_EPS = 0.9, 1e-8  # nu starts at 0 (initial_scale)
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_EPS = 1e-30
ADAFACTOR_MIN_SCALE = 1e-3


class _OptaxChain(torch.optim.Optimizer):
    """Base of the optimizers written out to an optax chain at its defaults.
    Each parameter has its slots from construction and its own int32
    ``step`` on its device (the chain's count); every step updates every
    parameter, one without a gradient as with a zero gradient. ``lr``: a
    number, or a function of the step count giving the rate (optax's
    schedule)."""

    def __init__(self, params: Iterable[torch.Tensor], lr):
        super().__init__(params, dict(lr=lr))
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                state["step"] = torch.zeros((), dtype=torch.int32, device=p.device)
                self._init_slots(p, state)

    def _init_slots(self, p: torch.Tensor, state: dict) -> None:
        raise NotImplementedError

    def _update(self, p, g, state, lr):
        """The update the chain adds to ``p`` (its slots moved in place)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state[p]
                lr = group["lr"](state["step"]) if callable(group["lr"]) else group["lr"]
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.add_(self._update(p, g, state, lr))
                state["step"].add_(1)


def _adam_direction(g, state, eps: float) -> torch.Tensor:
    """optax.scale_by_adam (b1 0.9, b2 0.999): the moments moved in place,
    and ``mu_hat / (sqrt(nu_hat) + eps)`` with the bias corrections in
    float32."""
    mu, nu = state["mu"], state["nu"]
    mu.copy_((1 - ADAM_B1) * g + ADAM_B1 * mu)
    nu.copy_((1 - ADAM_B2) * g * g + ADAM_B2 * nu)
    t = (state["step"] + 1).to(torch.float32)
    # float32 powers on the device (torch.full: no copy from the host, so
    # that a capture holds them)
    mu_hat = mu / (1 - torch.full_like(t, ADAM_B1) ** t)
    nu_hat = nu / (1 - torch.full_like(t, ADAM_B2) ** t)
    return mu_hat / (torch.sqrt(nu_hat) + eps)


def _adam_slots(p, state):
    state["mu"], state["nu"] = torch.zeros_like(p), torch.zeros_like(p)


class AdamW(_OptaxChain):
    """optax.adamw: Adam's direction (eps 1e-8) plus ``1e-4 * p`` on every
    parameter (tables and biases too: no mask), times ``-lr``."""

    _init_slots = staticmethod(_adam_slots)
    weight_decay = ADAMW_WEIGHT_DECAY

    def _update(self, p, g, state, lr):
        u = _adam_direction(g, state, ADAMW_EPS)
        if self.weight_decay:
            u = u + self.weight_decay * p
        return u * -lr


class Adam(AdamW):
    """optax.adam (eps 1e-8), term for term: AdamW's chain without the
    decay. ``compile("adam")`` takes it where the learning rate is a
    function of the step. A number rate keeps ``torch.optim.Adam``: its
    multi-tensor step is a few launches for all parameters, where this
    chain makes several for each parameter, and the card's one-step
    training routes are bound by the host's launches (PERF.md §5)."""

    weight_decay = 0.0


class RMSprop(_OptaxChain):
    """optax.rmsprop: ``nu = 0.1 g**2 + 0.9 nu`` from 0, the update
    ``-lr * g * rsqrt(nu + 1e-8)`` (eps in the root)."""

    def _init_slots(self, p, state):
        state["nu"] = torch.zeros_like(p)

    def _update(self, p, g, state, lr):
        nu = state["nu"]
        nu.copy_((1 - RMSPROP_DECAY) * g * g + RMSPROP_DECAY * nu)
        return torch.rsqrt(nu + RMSPROP_EPS) * g * -lr


class Lamb(_OptaxChain):
    """optax.lamb: Adam's direction (eps 1e-6; weight decay 0), scaled by the
    trust ratio ``|p| / |u|`` (1 where either norm is 0), times ``-lr``."""

    _init_slots = staticmethod(_adam_slots)

    def _update(self, p, g, state, lr):
        u = _adam_direction(g, state, LAMB_EPS)
        # sqrt(sum(x * x)), optax's formula: torch's float32 vector_norm on
        # the CPU is 1% off over a 98.5M-element table, the sum is not
        pn, un = torch.sqrt((p * p).sum()), torch.sqrt((u * u).sum())
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
        return u * ratio * -lr


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest dimension and
    the largest, where a parameter of two or more dimensions has its second
    largest at least 128 (``min_dim_size_to_factor``); else None (not
    factored)."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])  # stable, as np.argsort
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return order[-2], order[-1]


class Adafactor(_OptaxChain):
    """optax.adafactor's chain: ``scale_by_factored_rms`` (decay
    ``1 - (t + 1)**-0.8``, eps 1e-30; a parameter factored into row and
    column second moments where :func:`factored_dims` says so, else one
    second moment of its shape), ``clip_by_block_rms(1.0)``, the learning
    rate, ``scale_by_param_block_rms`` (the parameter's RMS, at least 1e-3),
    and the sign. A port Dense's weight is the JAX kernel transposed: its
    factors swap roles, and the factored update, symmetric in them, is the
    same."""

    def _init_slots(self, p, state):
        dims = factored_dims(p.shape)
        if dims is None:
            state["v"] = torch.zeros_like(p)
            return
        d1, d0 = dims
        state["v_row"] = p.new_zeros(tuple(n for i, n in enumerate(p.shape) if i != d0))
        state["v_col"] = p.new_zeros(tuple(n for i, n in enumerate(p.shape) if i != d1))

    def _update(self, p, g, state, lr):
        t = (state["step"] + 1).to(torch.float32)
        d = 1.0 - t ** -ADAFACTOR_DECAY_RATE
        g2 = g * g + ADAFACTOR_EPS
        dims = factored_dims(p.shape)
        if dims is None:
            v = state["v"]
            v.copy_(d * v + (1.0 - d) * g2)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            vr, vc = state["v_row"], state["v_col"]
            vr.copy_(d * vr + (1.0 - d) * g2.mean(dim=d0))
            vc.copy_(d * vc + (1.0 - d) * g2.mean(dim=d1))
            row_mean = vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
            u = g * ((vr / row_mean) ** -0.5).unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
        u = u / torch.clamp_min(torch.sqrt((u * u).mean()) / ADAFACTOR_CLIPPING_THRESHOLD, 1.0)
        u = u * lr
        rms = torch.sqrt((p * p).mean())
        u = u * torch.where(rms <= ADAFACTOR_MIN_SCALE,
                            torch.full_like(rms, ADAFACTOR_MIN_SCALE), rms)
        return u * -1


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


def check_optimizer(optimizer) -> None:
    """Raise unless ``optimizer`` is a dense optimizer's name or a
    :class:`MultiOptimizer`."""
    if isinstance(optimizer, MultiOptimizer) or optimizer in DENSE_OPTIMIZERS:
        return
    raise ValueError(f"Unknown optimizer {optimizer!r}; options {sorted(DENSE_OPTIMIZERS)}")


class NoParameters:
    """The dense optimizer of a model whose every parameter trains
    row-sparsely (a matrix factorization under ``embedding_optimizer``):
    nothing to step, as optax steps an empty tree."""

    state: dict = {}
    param_groups: list = []

    def step(self, closure=None) -> None:
        pass

    def state_dict(self) -> dict:
        return {"state": {}, "param_groups": []}


_CHAINS = {"adamw": AdamW, "rmsprop": RMSprop, "lamb": Lamb, "adafactor": Adafactor,
           "adagrad": Adagrad, "sgd": SGD}


def make_optimizer(name: str, params: Iterable[torch.Tensor],
                   learning_rate: Union[None, float, Callable]) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` (:class:`NoParameters` where
    there are none); the learning rate defaults to 1e-3, as in the JAX
    package. Every one takes a function of the step count (an int32 tensor
    on the parameters' device, 0 at the first step) as its learning rate,
    evaluated inside the step, so that a captured chunk replays the
    schedule (adam then runs as :class:`Adam`)."""
    check_optimizer(name)
    lr = 1e-3 if learning_rate is None else learning_rate
    params = list(params)
    if not params:
        return NoParameters()
    if name in _CHAINS:
        return _CHAINS[name](params, lr if callable(lr) else float(lr))
    if callable(lr):
        return Adam(params, lr)
    return torch.optim.Adam(params, lr=float(lr), eps=1e-8,
                            capturable=any(p.device.type == "cuda" for p in params))


def param_path(name: str) -> str:
    """A parameter's JAX state path from its ``named_parameters()`` name:
    ``/`` for ``.``, a Dense's ``weight`` as ``kernel`` (``load_jax_params``'s
    correspondence)."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


class MultiOptimizer:
    """Parameters routed to different optimizers by rule, the JAX package's
    ``MultiOptimizer`` (``optax.multi_transform``): ``rules`` is a sequence
    of ``(selector, optimizer)``, the first matching rule wins, everything
    else takes ``default``. A selector is a regex searched in a parameter's
    JAX state path (:func:`param_path`: the port's ``named_parameters()``
    name with ``/`` for ``.`` and a Dense's ``weight`` named ``kernel``, e.g.
    ``blocks/0/layers/0/branches/categorical/branches/item_id/table``), or a
    block, matching its parameters. An optimizer is a name of
    ``compile()``'s (at ``compile``'s learning rate) or a ``(name,
    learning_rate)`` pair.

    >>> MultiOptimizer(default="adam", rules=[("table", ("adagrad", 0.05))])
    """

    def __init__(self, default, rules: Sequence[tuple] = ()):
        self.default = default
        self.rules = list(rules)

    @staticmethod
    def _make(spec, params: list, learning_rate):
        name, lr = spec if isinstance(spec, tuple) else (spec, learning_rate)
        return make_optimizer(name, params, lr)

    def build(self, named_params, learning_rate=None) -> "MultiStep":
        """The optimizers over ``named_params`` ((name, parameter) pairs), one
        a rule that matched any, and the default's."""
        owned = [None if isinstance(sel, str) else {id(p) for p in sel.parameters()}
                 for sel, _ in self.rules]
        groups: Dict[int, list] = {}
        for name, p in named_params:
            path = param_path(name)
            label = next((i for i, (sel, _) in enumerate(self.rules)
                          if (re.search(sel, path) if owned[i] is None else id(p) in owned[i])),
                         -1)
            groups.setdefault(label, []).append(p)
        specs = {-1: self.default, **{i: spec for i, (_, spec) in enumerate(self.rules)}}
        return MultiStep({label: self._make(specs[label], ps, learning_rate)
                          for label, ps in sorted(groups.items())})


class MultiStep:
    """The optimizers a :class:`MultiOptimizer` built, stepped as one
    (``optimizers``: by rule index, -1 the default's); ``state`` holds every
    parameter's."""

    def __init__(self, optimizers: Dict[int, torch.optim.Optimizer]):
        self.optimizers = optimizers

    @property
    def state(self) -> dict:
        return {p: st for opt in self.optimizers.values() for p, st in opt.state.items()}

    @property
    def param_groups(self) -> list:
        return [g for opt in self.optimizers.values() for g in opt.param_groups]

    def step(self, closure=None, lookups=None) -> None:
        """Each optimizer's step; ``lookups`` go to the :class:`Adagrad` and
        :class:`SGD` among them (the row route)."""
        for opt in self.optimizers.values():
            opt.step(lookups=lookups) if isinstance(opt, _Foreach) else opt.step()

    def state_dict(self) -> dict:
        """Each optimizer's ``state_dict()`` under ``state``, by rule index."""
        return {"state": {label: opt.state_dict() for label, opt in self.optimizers.items()},
                "param_groups": []}

    def load_state_dict(self, state_dict: dict) -> None:
        for label, opt in self.optimizers.items():
            opt.load_state_dict(state_dict["state"][label])


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
    def apply(self, table, ids: torch.Tensor, grads: torch.Tensor, step: int, mesh=None,
              axis: str = "model") -> None:
        """Update ``table`` and its slots at the looked-up rows. ``ids``
        (...,) of any integer type, ``grads`` (..., D): each lookup's row
        gradient. Equal ids are summed first, so each row takes one update
        from its summed gradient, as a dense gradient would give it.

        A table split by rows over a mesh (its ``shard``, ``parallel/
        mesh.py``; ``mesh`` and ``axis`` are the JAX signature's and the
        table's own placement decides) takes the update of the rows it owns
        on its own table and slot shards, the slot math and the commit (K7;
        K8 with stochastic rounding on bf16) unchanged: ``ids`` and
        ``grads`` are then the global batch's, the same on every rank, so
        that nothing table-sized moves between ranks and every rank's noise
        is the single device's."""
        flat_ids = ids.reshape(-1).to(torch.int32)
        flat_g = grads.reshape(-1, grads.shape[-1]).float()
        sids, gsum, valid = dedup_rows(flat_ids, flat_g)
        shard = getattr(table, "shard", None)
        if shard is not None:
            from ..ops.embedding_lookup import owned_rows

            sids, valid = owned_rows(table.table, sids, valid, shard.mesh, shard.axis)
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
