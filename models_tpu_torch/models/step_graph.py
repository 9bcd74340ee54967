"""A chunk of k training steps captured as one CUDA graph and replayed: the
port's counterpart of ``jax.jit`` over the JAX package's ``lax.scan`` chunk
(``models_tpu/models/base.py::_make_device_chunk_step``, ``_make_multi_train_step``).

A chunk function ``fn(source, idx, states) -> (logs, states)`` gathers the
chunk's rows of the packed (n, F) int32 columns (``source``) at ``idx`` with
the row gather (K9) and runs k ``Model.train_step`` calls on contiguous
views of them (``Model._chunk_fn``). :class:`ChunkGraphs` runs it by key
(k, metrics or not, batch size, the pack's layout, the dtype policy), as
the JAX package caches ``chunk_fns``:

- the first call of a key runs the function eagerly on a side stream, as
  training that is kept: the kernels' first launches (``cudaFuncSetAttribute``,
  the TMA encoder's lookup, the occupancy queries), cuBLAS's workspaces and
  the optimizer's slots (Adam makes them at its first step, which
  ``LowPrecisionState`` then packs) all happen outside the capture;
- the second call captures the function into a ``torch.cuda.CUDAGraph``
  (its own memory pool, in which a step reuses the blocks the step before
  it freed), then replays it; every later call replays it. Before a replay
  the chunk's ids are copied into the graph's index buffer and the metric
  states into its state buffers; after it the logs and states are cloned
  out, since the next replay writes the same memory;
- a capture that fails raises: no call quietly runs eager steps instead.

What a graph holds by address: the parameters, the model's buffers, the
optimizer's state tensors (a bf16 optimizer state's flat tensor at rest),
the source, and the tensors it allocated itself (gradients, activations,
the gathered rows). Each call compares the first four with what the graph
captured and drops every graph when one was replaced (a buffer rebound by
``module.to()``, say); ``Model.compile()`` drops them too. A cross-batch
queue's ring is written in place at the end of each step
(``state_updates``), so a replay advances it as the eager steps do.

``evaluate``'s device route runs its chunks through a :class:`ChunkGraphs`
of its own (``Model._eval_graphs``): ``fn`` runs k evaluation steps over
the eval pack's rows at ``idx``, its states the metrics' and the loss sum
and batch count, its fingerprint :func:`eval_tensors` (no optimizer: a
top-k encoder that was never fit evaluates too), and a replay leaves the
step count alone. The top-k kernels (K4, K5, K6) launch inside such graphs;
what they decide at launch from shapes and addresses (K5's route and grid,
K4's design and its catalog's TMA map, cached by address, rows and width)
is fixed for the key's shapes and the fingerprint's addresses.

Python state does not replay: the model's step count is put back after a
capture, and each replay adds the chunk's k steps. The kernels' launch
counters are left alone: a wrapper counts the launches it issues, the eager
chunk's and the ones a capture records (which the capture's own replay
runs); later replays launch the recorded kernels with no Python call, and
are counted from a profiler trace of the replays (``chip_smoke.py``).
``ModelContext(step=...)`` is frozen at its capture value: no block on the
dense route reads it (the row-sparse update, which does, never takes this
route). The random numbers a chunk draws come from generators on the card
(each ``RandomBlock``'s own: ``Dropout``, the popularity sampler, the
random sequence transforms of ``fit(pre=)``), each registered with the
graph, so that every replay draws anew. Blocks that keep state across steps (BatchNorm's running
statistics) update it in place: a replay updates it as the eager steps do.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch
import torch.utils._pytree as pytree

from ..utils import trace


def captured_tensors(model, source: torch.Tensor) -> tuple:
    """(address, shape) of each tensor a training chunk's graph reads or
    writes that it did not allocate: the parameters, the model's buffers
    (BatchNorm's statistics, a cross-batch queue's ring), the optimizer's
    state tensors and the source."""
    opt = model._optimizer
    inner = getattr(opt, "optimizer", opt)
    ts = list(model.parameters()) + list(model.buffers())
    ts += [v for st in inner.state.values() for v in st.values() if torch.is_tensor(v)]
    rest = getattr(opt, "_rest", None)
    if rest is not None:
        ts.append(rest)
    ts.append(source)
    return tuple((t.data_ptr(), tuple(t.shape)) for t in ts)


def eval_tensors(model, source: torch.Tensor) -> tuple:
    """(address, shape) of each tensor an evaluation chunk's graph reads that
    it did not allocate: the parameters, the model's buffers (a top-k
    head's index among them) and the eval pack. No optimizer: a model that
    was never fit (a top-k encoder) evaluates too."""
    ts = list(model.parameters()) + list(model.buffers()) + [source]
    return tuple((t.data_ptr(), tuple(t.shape)) for t in ts)


def chunk_generators(model) -> list:
    """The generators on the card that the model's blocks draw from in
    training (``RandomBlock.generator``; ``fit``'s ``pre`` is one of the
    model's modules while it trains)."""
    gens = [getattr(m, "generator", None) for m in model.modules()]
    return [g for g in gens if isinstance(g, torch.Generator) and g.device.type == "cuda"]


class _Entry:
    """One key's state: warmed (eager run done) or captured."""

    def __init__(self):
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.idx: Optional[torch.Tensor] = None
        self.state_leaves: List[torch.Tensor] = []
        self.state_spec = None
        self.logs: Dict[str, torch.Tensor] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0


class ChunkGraphs:
    """The model's captured chunks, by key. ``stats`` keeps, per key, the
    capture's seconds and the bytes its memory pool took. ``tensors(model,
    source)`` lists what the graphs hold by address (:func:`captured_tensors`
    for training chunks, :func:`eval_tensors` for evaluation chunks). Each
    branch of :meth:`run` is a span and a counter of
    :mod:`~models_tpu_torch.utils.trace` (``graph.eager``, ``graph.capture``
    / ``graph.captures``, ``graph.replay`` / ``graph.replays``), and a
    fingerprint that no longer matches counts ``graph.drops``."""

    def __init__(self, tensors: Callable = captured_tensors):
        self._entries: Dict[tuple, _Entry] = {}
        self._fingerprint: Optional[tuple] = None
        self._tensors = tensors
        self.stats: Dict[tuple, dict] = {}

    def clear(self) -> None:
        self._entries.clear()
        self._fingerprint = None

    def __deepcopy__(self, memo) -> "ChunkGraphs":
        # a graph holds the original's tensors by address: a copy starts
        # with none (and a CUDA graph cannot be copied)
        return ChunkGraphs(self._tensors)

    def __len__(self) -> int:
        return sum(e.graph is not None for e in self._entries.values())

    def run(self, model, key: tuple, fn: Callable, source: torch.Tensor, idx: torch.Tensor,
            states, k: int):
        """``fn(source, idx, states)`` for the chunk of ``k`` steps under
        ``key``: eager on a side stream the first time, captured the second,
        replayed after. Returns (logs, states), the logs (k,) tensors. A
        replay adds ``k`` to the model's step count (an evaluation chunk
        passes 0: it trains nothing)."""
        fingerprint = self._tensors(model, source)
        if fingerprint != self._fingerprint:
            if self._fingerprint is not None:
                trace.count("graph.drops")
            self.clear()
            self._fingerprint = fingerprint
        entry = self._entries.get(key)
        if entry is None:
            trace.count("graph.eager")
            with trace.span("graph.eager"):
                side = torch.cuda.Stream(source.device)
                side.wait_stream(torch.cuda.current_stream(source.device))
                with torch.cuda.stream(side):
                    out = fn(source, idx, states)
                torch.cuda.current_stream(source.device).wait_stream(side)
            self._entries[key] = _Entry()
            # the eager run may pack new optimizer slots: what the graph holds
            self._fingerprint = self._tensors(model, source)
            return out
        if entry.graph is None:
            trace.count("graph.captures")
            with trace.span("graph.capture"):
                self._capture(model, key, entry, fn, source, idx, states, k)
        trace.count("graph.replays")
        with trace.span("graph.replay"):
            return self._replay(model, entry, idx, states, k)

    def _capture(self, model, key, entry: _Entry, fn, source, idx, states, k) -> None:
        dev = source.device
        leaves, entry.state_spec = pytree.tree_flatten(states)
        entry.idx = idx.clone()
        entry.state_leaves = [t.clone() for t in leaves]
        inp = pytree.tree_unflatten(entry.state_leaves, entry.state_spec)
        step0 = model._step
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # as the capture does on entry: the pool's bytes alone below
        reserved = torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0)
        graph = torch.cuda.CUDAGraph()
        for gen in chunk_generators(model):
            graph.register_generator_state(gen)
        t = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                logs, out = fn(source, entry.idx, inp)
                out_leaves = pytree.tree_leaves(out)
                # a chunk without metrics passes the states through; a chunk
                # with them leaves them where they came in
                through = len(out_leaves) == len(leaves) and all(
                    a is b for a, b in zip(out_leaves, entry.state_leaves))
                if not through:
                    torch._foreach_copy_(entry.state_leaves, out_leaves)
        except Exception as err:
            raise RuntimeError(f"capturing the chunk {key} as a CUDA graph failed: "
                               f"{err}") from err
        finally:
            model._step = step0
        if through:
            entry.state_leaves = []
        entry.capture_s = time.perf_counter() - t
        entry.pool_bytes = (torch.cuda.memory_stats(dev).get("reserved_bytes.all.current", 0)
                            - reserved)
        entry.logs = logs
        entry.graph = graph
        self.stats[key] = {"capture_s": entry.capture_s, "pool_bytes": entry.pool_bytes}

    @staticmethod
    def _replay(model, entry: _Entry, idx, states, k):
        entry.idx.copy_(idx)
        if entry.state_leaves:
            torch._foreach_copy_(entry.state_leaves, pytree.tree_leaves(states))
        entry.graph.replay()
        model._step += k
        logs = {name: v.clone() for name, v in entry.logs.items()}
        if not entry.state_leaves:
            return logs, states
        return logs, pytree.tree_unflatten([t.clone() for t in entry.state_leaves],
                                           entry.state_spec)
