"""The port's sharded ops against the JAX package's, on the CPU: four gloo
ranks (``torch_mesh_workers.sharded_ops_suite``, started once for the file)
against JAX's ``shard_map`` ops on a mesh of 4 forced host devices of the
same shape (``tests/conftest.py``).

- ``sharded_lookup`` (the ``a2a`` and ``psum`` strategies) on a table split
  by rows over the model axis, the ids split over the data axis, with ids
  out of range: each rank's rows equal its slice of JAX's output and of the
  plain gather, and its shard's gradient, times the data axis (the port's
  is the gradient of the data line's mean), equals its rows of JAX's table
  gradient, within 1e-6;
- ``sharded_row_scatter_add`` and ``sharded_update_rows``: each rank's shard
  equals its rows of JAX's result, within 1e-6;
- ``sharded_topk`` over catalogs with planted exact ties (the streaming
  route at 16 rows a shard, the binned route at 1024), and the mesh-split
  ``BruteForce`` index in bf16 and int8 (bin-quantized where each shard is
  whole bins, one scale a row where not): ids equal to JAX's, ties
  included, scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from models_tpu.ops.embedding_lookup import sharded_lookup as jax_sharded_lookup
from models_tpu.ops.embedding_lookup import sharded_row_scatter_add as jax_scatter_add
from models_tpu.ops.embedding_lookup import sharded_update_rows as jax_update_rows
from models_tpu.ops.topk import sharded_topk as jax_sharded_topk
from models_tpu.outputs.topk import BruteForce as JBruteForce
from models_tpu.parallel.mesh import make_mesh as jax_make_mesh

import torch_mesh_workers as W
from models_tpu_torch.parallel.launch import spawn

R, D, B, K = 48, 5, 24, 5
TOPK_MESHES = ({"data": 1, "model": 4}, {"data": 2, "model": 2})


def jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices("cpu")[:4])


def lookup_inputs():
    rng = np.random.default_rng(11)
    uids = rng.choice(R, 10, replace=False).astype(np.int32)
    return {
        "table": rng.standard_normal((R, D)).astype(np.float32),
        "ids": rng.integers(-3, R + 3, B).astype(np.int64),  # out of range at both ends
        "w": rng.standard_normal((B, D)).astype(np.float32),
        "uids": uids,
        "valid": rng.random(10) < 0.7,
        "updates": rng.standard_normal((10, D)).astype(np.float32),
        "dup_ids": rng.integers(0, R, 10).astype(np.int32),  # repeats accumulate
    }


def topk_inputs():
    rng = np.random.default_rng(3)
    catalogs = {}
    for name, C in (("ties", 64), ("binned", 4096)):
        cand = rng.standard_normal((C, 8)).astype(np.float32)
        for j in (17, 40, C - 5):  # exact ties across shards
            cand[j] = cand[3]
        catalogs[name] = cand
    return {"queries": rng.standard_normal((6, 8)).astype(np.float32), "catalogs": catalogs,
            "k": K}


@pytest.fixture(scope="module")
def ranks():
    return spawn(W.sharded_ops_suite, 4, (lookup_inputs(), topk_inputs()), timeout=300)


def rows_of(full, m, n):
    rows = full.shape[0] // n
    return np.asarray(full)[m * rows:(m + 1) * rows]


@pytest.mark.parametrize("strategy", ("a2a", "psum"))
@pytest.mark.parametrize("shape", W.MESHES, ids=W.key)
def test_sharded_lookup_matches_jax(ranks, shape, strategy):
    case = lookup_inputs()
    mesh = jax_mesh(shape)
    table, ids, w = (jnp.asarray(case[k]) for k in ("table", "ids", "w"))

    def loss(t):
        out = jax_sharded_lookup(t, ids, mesh, data_axis="data", strategy=strategy)
        return (out * w).sum(), out

    (_, out), grad = jax.value_and_grad(loss, has_aux=True)(table)
    plain = case["table"][np.clip(case["ids"], 0, R - 1)] * (
        (case["ids"] >= 0) & (case["ids"] < R))[:, None]
    np.testing.assert_allclose(np.asarray(out), plain, atol=1e-6)
    n, dp = shape["model"], shape["data"]
    b = B // dp
    for rank, res in enumerate(ranks):
        d, m = rank // n, rank % n
        got, g = res["lookup"][W.key(shape)][strategy]
        np.testing.assert_allclose(got, np.asarray(out)[d * b:(d + 1) * b], atol=1e-6)
        np.testing.assert_allclose(got, plain[d * b:(d + 1) * b], atol=1e-6)
        np.testing.assert_allclose(g * dp, rows_of(grad, m, n), atol=1e-6)


@pytest.mark.parametrize("shape", W.MESHES, ids=W.key)
def test_sharded_scatters_match_jax(ranks, shape):
    case = lookup_inputs()
    mesh = jax_mesh(shape)
    table = jnp.asarray(case["table"])
    add = jax_scatter_add(table, jnp.asarray(case["uids"]), jnp.asarray(case["updates"]),
                          jnp.asarray(case["valid"]), mesh)
    upd = jax_update_rows(table, jnp.asarray(case["dup_ids"]), jnp.asarray(case["updates"]),
                          mesh)
    n = shape["model"]
    for rank, res in enumerate(ranks):
        m = rank % n
        np.testing.assert_allclose(res["lookup"][W.key(shape)]["scatter_add"],
                                   rows_of(add, m, n), atol=1e-6)
        np.testing.assert_allclose(res["lookup"][W.key(shape)]["update_rows"],
                                   rows_of(upd, m, n), atol=1e-6)


@pytest.mark.parametrize("catalog", ("ties", "binned"))
@pytest.mark.parametrize("shape", TOPK_MESHES, ids=W.key)
def test_sharded_topk_matches_jax(ranks, shape, catalog):
    case = topk_inputs()
    mesh = jax_mesh(shape)
    q, cand = jnp.asarray(case["queries"]), jnp.asarray(case["catalogs"][catalog])
    s_ref, i_ref = jax_sharded_topk(q, cand, K, mesh, axis="model")
    for res in ranks:
        s, i = res["topk"][W.key(shape)][catalog]
        np.testing.assert_array_equal(i, np.asarray(i_ref))
        np.testing.assert_allclose(s, np.asarray(s_ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ("bfloat16", "int8"))
@pytest.mark.parametrize("catalog", ("ties", "binned"))
@pytest.mark.parametrize("shape", TOPK_MESHES, ids=W.key)
def test_mesh_index_matches_jax(ranks, shape, catalog, dtype):
    case = topk_inputs()
    mesh = jax_mesh(shape)
    layer = JBruteForce(k=K).index(jnp.asarray(case["catalogs"][catalog]), mesh=mesh,
                                   dtype=getattr(jnp, dtype))
    pred = layer(jnp.asarray(case["queries"]))
    for res in ranks:
        s, i = res["topk"][W.key(shape)][f"{catalog}/{dtype}"]
        np.testing.assert_array_equal(i, np.asarray(pred.identifiers))
        np.testing.assert_allclose(s, np.asarray(pred.scores), rtol=1e-5, atol=1e-6)
