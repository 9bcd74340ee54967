"""The port's cross-batch negatives (``outputs/queue.py``: ``FIFOQueue``,
``CachedCrossBatchSampler``) against the JAX package's, on the CPU.

The ring's enqueue is held to ``FIFOQueue.enqueue_functional`` exactly
(n < capacity with and without a wrap, n == capacity, n > capacity). The
matrix factorization with ``["in-batch", cross-batch]`` negatives (dim 8,
batches of 64, a 128-slot ring, so the third step wraps it) trains next to
the JAX model, its parameters carried over with ``load_jax_params``, one
batch (or one chunk of ``steps_per_execution=2``) a ``fit``: after each,
the logged losses within rtol 1e-5, the tables within atol 1e-6 (the port
tests' bounds: float32 sums in another order), and the ring, its ids and
its cursor equal. The head whose one sampler is the queue (autograd saves
the ring for the backward; the engine writes it only after the step)
trains alike. Unfilled slots score ``MIN_FLOAT``: the fused loss equals the
unfused at T = 1.4 and T = 0.6 on an empty and a full ring (loss rtol 1e-5,
gradients within 2e-5 of the largest), and an empty slot takes no gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from models_tpu.data import Loader as JLoader
from models_tpu.data import generate_data as jax_generate
from models_tpu.models import MatrixFactorizationModel as JMF
from models_tpu.outputs.queue import CachedCrossBatchSampler as JCross
from models_tpu.outputs.queue import FIFOQueue as JFIFO

import models_tpu_torch as mt
from models_tpu_torch.core.constants import MIN_FLOAT
from models_tpu_torch.core.types import ModelContext
from models_tpu_torch.models.step_graph import captured_tensors
from models_tpu_torch.outputs.contrastive import ContrastiveOutput
from models_tpu_torch.outputs.queue import CachedCrossBatchSampler, FIFOQueue
from models_tpu_torch.outputs.sampling import CandidateSampler
from models_tpu_torch.schema import Tags
from models_tpu_torch.schema import create_categorical_column as tcat

B, DIM, CAP = 64, 8, 128
LR = 0.05


def jax_vars(model):
    return {"/".join(str(p) for p in path): np.asarray(v[...])
            for path, v in nnx.state(model, nnx.Variable).flat_state()}


def assert_state_equal(tm, jm, atol=1e-6):
    """Every parameter and buffer of the port against the JAX model's
    variable of the same path: floats within atol, ints equal."""
    want = jax_vars(jm)
    got = dict(list(tm.named_parameters()) + list(tm.named_buffers()))
    assert sorted(k.replace(".", "/") for k in got) == sorted(want)
    for name, t in got.items():
        key = name.replace(".", "/")
        value = t.detach().numpy()
        if value.dtype.kind == "f":
            np.testing.assert_allclose(value, want[key], rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(value, want[key], err_msg=key)


def build_pair(samplers, seed=3, rows=B):
    """The JAX MF built, and the port's with its state (tables and ring)."""
    jds = jax_generate("movielens-25m", num_rows=rows, seed=0)
    tds = mt.generate_data("movielens-25m", num_rows=rows, seed=0)
    jm = JMF(jds.schema, dim=DIM, seed=seed,
             negative_samplers=[JCross(CAP, DIM) if s == "q" else s for s in samplers])
    jm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    jm.build(JLoader(jds, B))
    tm = mt.MatrixFactorizationModel(
        tds.schema, dim=DIM, seed=seed, device="cpu",
        negative_samplers=[CachedCrossBatchSampler(CAP, DIM) if s == "q" else s
                           for s in samplers])
    tm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    mt.load_jax_params(tm, jax_vars(jm))
    return jm, tm


def step_data(i, rows):
    return (jax_generate("movielens-25m", num_rows=rows, seed=10 + i),
            mt.generate_data("movielens-25m", num_rows=rows, seed=10 + i))


@pytest.mark.parametrize("cap,prefill,n", [
    (16, 3, 5),    # n < cap, no wrap
    (16, 13, 7),   # n < cap, wraps past the end
    (16, 5, 16),   # n == cap
    (16, 9, 37),   # n > cap: the last cap rows, rolled by the new cursor
])
def test_fifo_enqueue_matches_jax(cap, prefill, n):
    rng = np.random.default_rng(cap + prefill + n)
    jq, tq = JFIFO(cap, 4), FIFOQueue(cap, 4)
    first = rng.normal(size=(prefill, 4)).astype(np.float32)
    jq.enqueue(jnp.arange(prefill, dtype=jnp.int32), jnp.asarray(first))
    tq.enqueue(torch.arange(prefill, dtype=torch.int32), torch.from_numpy(first))
    ids = rng.integers(0, 1000, n).astype(np.int32)
    emb = rng.normal(size=(n, 4)).astype(np.float32)
    want = jq.enqueue_functional(jnp.asarray(ids), jnp.asarray(emb))
    got = tq.enqueue_functional(torch.from_numpy(ids), torch.from_numpy(emb))
    for g, w, name in zip(got, want, ("embeddings", "ids", "cursor")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32 and got[2].ndim == 0
    # enqueue_functional wrote nothing; enqueue writes in place
    before = tq.embeddings.data_ptr()
    tq.enqueue(torch.from_numpy(ids), torch.from_numpy(emb))
    assert tq.embeddings.data_ptr() == before
    np.testing.assert_array_equal(tq.ids.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("samplers", [["in-batch", "q"], ["q"]], ids=["in-batch+queue", "queue"])
def test_mf_cross_batch_steps_match_jax(samplers):
    """Three steps, each its own fit of one batch: losses, tables, ring."""
    jm, tm = build_pair(samplers)
    for i in range(3):
        jds, tds = step_data(i, B)
        jh = jm.fit(jds, epochs=1, batch_size=B, shuffle=False, verbose=0).history
        th = tm.fit(tds, epochs=1, batch_size=B, shuffle=False, device="cpu").history
        for key in ("loss", "loss/movieId/ContrastiveOutput", "regularization_loss"):
            np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, atol=1e-7, err_msg=key)
        assert_state_equal(tm, jm)
    queue = tm.contrastive_output.samplers[-1].queue
    assert int(queue.cursor) == (3 * B) % CAP and bool((queue.ids >= 0).all())


def test_mf_cross_batch_chunks_match_jax():
    """steps_per_execution=2: three fits of one chunk of two steps each."""
    jm, tm = build_pair(["in-batch", "q"])
    kw = dict(optimizer="adagrad", learning_rate=LR, metrics=[], steps_per_execution=2)
    jm.compile(**kw)
    tm.compile(**kw)
    for i in range(3):
        jds, tds = step_data(i, 2 * B)
        jh = jm.fit(jds, epochs=1, batch_size=B, shuffle=False, verbose=0).history
        th = tm.fit(tds, epochs=1, batch_size=B, shuffle=False, device="cpu").history
        np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5, atol=1e-7)
        assert_state_equal(tm, jm)
    assert tm._step == 6


def _tied_head(samplers, T):
    col = tcat("item", 39, tags=(Tags.ITEM, Tags.ITEM_ID))
    table = mt.inputs.EmbeddingTable(DIM, col, seed=1, device="cpu")
    return ContrastiveOutput(table, negative_samplers=samplers, logits_temperature=T), table


def _head_loss(head, q, ids, fused):
    ctx = ModelContext(features={"item": ids}, need_logits=not fused)
    pred = head(q, training=True, context=ctx)
    if fused:
        assert pred.precomputed_loss is not None
        return pred.precomputed_loss, ctx
    assert pred.precomputed_loss is None
    return mt.losses.categorical_crossentropy(pred.targets, pred.outputs), ctx


@pytest.mark.parametrize("T", [1.4, 0.6])
@pytest.mark.parametrize("fill", ["empty", "full"])
def test_fused_equals_unfused_over_invalid_slots(T, fill):
    """``["in-batch", queue]`` at temperature T, the ring empty (every slot
    invalid: bias MIN_FLOAT, zeroed rows) or full: the fused loss and its
    gradients against the unfused logits' CE."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(12, DIM)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 40, 12).astype(np.int32))
    ring_ids = torch.from_numpy(rng.integers(0, 40, 16).astype(np.int32))
    ring = torch.from_numpy(rng.normal(size=(16, DIM)).astype(np.float32))
    results = []
    for fused in (True, False):
        sampler = CachedCrossBatchSampler(16, DIM)
        if fill == "full":
            sampler.queue.enqueue(ring_ids, ring)
        head, table = _tied_head(["in-batch", sampler], T)
        qg = q.clone().requires_grad_()
        loss, ctx = _head_loss(head, qg, ids, fused)
        loss.backward()
        assert torch.isfinite(loss) and len(ctx["state_updates"]) == 3
        results.append((loss.detach(), qg.grad, table.table.grad))
    (lf, qf, tf), (lu, qu, tu) = results
    np.testing.assert_allclose(float(lf), float(lu), rtol=1e-5)
    scale = max(float(qu.abs().max()), float(tu.abs().max()))
    for got, want in ((qf, qu), (tf, tu)):
        assert float((got - want).abs().max()) <= 2e-5 * scale


def test_empty_slots_score_min_float_and_take_no_gradient():
    """The first step sees an empty ring: every queue column is MIN_FLOAT /
    T; the plain K3 gives its rows zero gradient; the ring is unchanged
    until the engine writes the step's state updates."""
    from models_tpu_torch.ops import flash_ce

    sampler = CachedCrossBatchSampler(8, DIM)
    head, _ = _tied_head(["in-batch", sampler], 0.6)
    q = torch.randn(3, DIM, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([1, 2, 3], dtype=torch.int32)
    ctx = ModelContext(features={"item": ids})
    pred = head(q, training=True, context=ctx)
    assert pred.outputs.shape == (3, 1 + 3 + 8)
    np.testing.assert_allclose(pred.outputs[:, 4:].detach().numpy(), MIN_FLOAT / 0.6)
    assert bool((sampler.queue.ids == -1).all())  # deferred
    mt.models.base.apply_state_updates(ctx["state_updates"])
    np.testing.assert_array_equal(sampler.queue.ids[:3].numpy(), [1, 2, 3])
    assert int(sampler.queue.cursor) == 3
    # K3's plain version over the invalid rows (zeroed, bias MIN_FLOAT)
    neg = torch.zeros(8, DIM)
    bias = torch.full((8,), MIN_FLOAT)
    pos_logit = (q * q).sum(1) / 0.6
    m, s = flash_ce.lse_forward(q, pos_logit, neg, None, None, bias, 0.6, False)
    lse = m + torch.log(s)
    assert torch.isfinite(lse).all()
    dneg = flash_ce.grad_neg(q, neg, lse, torch.full((3,), 1 / 3), None, None, bias, 0.6, False)
    assert float(dneg.abs().max()) == 0.0


def test_sampler_names_and_eager_enqueue():
    assert isinstance(CandidateSampler.parse("cross-batch"), CachedCrossBatchSampler)
    s = CandidateSampler.parse("cached-cross-batch")
    assert s.queue.capacity == 4096 and s.queue.dim == 64
    # called with no context, the enqueue is immediate and the snapshot the old ring
    small = CachedCrossBatchSampler(4, 2)
    pos = mt.outputs.Candidate(id=torch.tensor([5, 6]), embedding=torch.ones(2, 2))
    snap = small(pos, training=True)
    assert bool((snap.id == -1).all()) and not bool(snap.valid.any())
    np.testing.assert_array_equal(small.queue.ids.numpy(), [5, 6, -1, -1])
    snap = small(pos, training=False)
    assert int(snap.valid.sum()) == 2 and int(small.queue.cursor) == 2


def test_captured_graphs_key_the_model_buffers():
    """A chunk's graph holds the ring by address: the fingerprint that
    drops stale graphs covers the model's buffers."""
    _, tm = build_pair(["in-batch", "q"])
    tm.compile(optimizer="adagrad", learning_rate=LR, metrics=[])
    tm._build_optimizer()
    queue = tm.contrastive_output.samplers[-1].queue
    source = torch.zeros(4, 2, dtype=torch.int32)
    before = captured_tensors(tm, source)
    assert (queue.embeddings.data_ptr(), tuple(queue.embeddings.shape)) in before
    queue.embeddings = queue.embeddings.clone()  # rebound, as a load or a move would
    assert captured_tensors(tm, source) != before
