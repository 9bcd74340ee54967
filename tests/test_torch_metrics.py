"""The port's top-k metrics (models_tpu_torch.metrics.topk) against the JAX
package's (models_tpu.metrics.topk), on the CPU, on the same seeded numpy
inputs.

The metric functions are fp32 arithmetic in the same order: rtol 1e-6 (a
log2 or a division may round one ulp apart). extract_topk without tie
shuffling is the same stable selection; with it, the port's permutation is
not JAX's, so the two agree on scores without ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import models_tpu.metrics.topk as J
import models_tpu_torch.metrics.topk as T
from models_tpu_torch.metrics.base import Metric

RTOL = 1e-6


def _rel(seed, B=40, k=12):
    rng = np.random.default_rng(seed)
    rel = (rng.random((B, k)) < 0.25).astype(np.float32)
    num_rel = rng.integers(0, 20, B).astype(np.float32)
    return rel, num_rel


@pytest.mark.parametrize("fn", ["recall_at", "precision_at", "average_precision_at", "dcg_at",
                                "ndcg_at", "mrr_at"])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_metric_functions_match_jax(fn, k):
    rel, num_rel = _rel(k)
    ref = getattr(J, fn)(k, jnp.asarray(rel), jnp.asarray(num_rel))
    got = getattr(T, fn)(k, torch.from_numpy(rel), torch.from_numpy(num_rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-7)


def _scores(seed, B, C, ties):
    rng = np.random.default_rng(seed)
    if ties:
        s = rng.integers(0, 4, (B, C)).astype(np.float32)
    else:
        s = rng.permutation(B * C).reshape(B, C).astype(np.float32) / (B * C)
    t = np.zeros((B, C), np.float32)
    t[np.arange(B), rng.integers(0, C, B)] = 1.0
    t[::3, rng.integers(0, C)] = 1.0  # some rows with two relevant items
    return s, t


@pytest.mark.parametrize("shuffle", [False, True])
def test_extract_topk_matches_jax(shuffle):
    s, t = _scores(1, 16, 30, ties=False)  # tie-free: the permutation cannot matter
    js, jr, ji = J.extract_topk(7, jnp.asarray(s), jnp.asarray(t), shuffle_ties=shuffle)
    ts, tr, ti = T.extract_topk(7, torch.from_numpy(s), torch.from_numpy(t), shuffle_ties=shuffle)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_extract_topk_without_shuffle_breaks_ties_by_position():
    s, t = _scores(2, 8, 20, ties=True)
    js, jr, ji = J.extract_topk(10, jnp.asarray(s), jnp.asarray(t), shuffle_ties=False)
    ts, tr, ti = T.extract_topk(10, torch.from_numpy(s), torch.from_numpy(t), shuffle_ties=False)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_shuffled_ties_are_a_permutation_drawn_from_the_batch():
    """Ties land in a random order that depends on the batch's bits, and the
    selected scores are the sorted scores whatever the order."""
    s = np.zeros((4, 50), np.float32)  # every score tied
    t = np.zeros((4, 50), np.float32)
    t[:, 3] = 1.0
    ts, _, ti = T.extract_topk(50, torch.from_numpy(s), torch.from_numpy(t))
    assert sorted(ti[0].tolist()) == list(range(50)) and ti[0].tolist() != list(range(50))
    t2 = t.copy()
    t2[:, 4] = 1.0
    _, _, ti2 = T.extract_topk(50, torch.from_numpy(s), torch.from_numpy(t2))
    assert ti2[0].tolist() != ti[0].tolist()
    s3, t3 = _scores(3, 6, 40, ties=True)
    ts3, _, _ = T.extract_topk(10, torch.from_numpy(s3), torch.from_numpy(t3))
    np.testing.assert_array_equal(ts3.numpy(), -np.sort(-s3, axis=1)[:, :10])


@pytest.mark.parametrize("weighted", [False, True])
def test_aggregator_matches_jax(weighted):
    s, t = _scores(4, 32, 25, ties=False)
    w = np.random.default_rng(5).random(32).astype(np.float32) if weighted else None
    jagg, tagg = J.TopKMetricsAggregator.default(10), T.TopKMetricsAggregator.default(10)
    jst, tst = jagg.init_state(), tagg.init_state()
    for half in (slice(0, 16), slice(16, 32)):  # two batches
        jst = jagg.update(jst, jnp.asarray(s[half]), jnp.asarray(t[half]),
                          sample_weight=None if w is None else jnp.asarray(w[half]))
        tst = tagg.update(tst, torch.from_numpy(s[half]), torch.from_numpy(t[half]),
                          sample_weight=None if w is None else torch.from_numpy(w[half]))
    jres, tres = jagg.result(jst), tagg.result(tst)
    assert sorted(tres) == sorted(jres) == sorted(
        ["recall_at_10", "mrr_at_10", "ndcg_at_10", "map_at_10", "precision_at_10"])
    for key in jres:
        np.testing.assert_allclose(float(tres[key]), float(jres[key]), rtol=RTOL, err_msg=key)


def test_single_metrics_and_label_relevant_counts_match_jax():
    s, t = _scores(6, 20, 15, ties=False)
    counts = np.random.default_rng(7).integers(1, 6, 20).astype(np.float32)
    for cls in ("RecallAt", "PrecisionAt", "AvgPrecisionAt", "NDCGAt", "MRRAt"):
        jm, tm = getattr(J, cls)(5), getattr(T, cls)(5)
        jst = jm.update(jm.init_state(), jnp.asarray(s), jnp.asarray(t),
                        label_relevant_counts=jnp.asarray(counts))
        tst = tm.update(tm.init_state(), torch.from_numpy(s), torch.from_numpy(t),
                        label_relevant_counts=torch.from_numpy(counts))
        np.testing.assert_allclose(float(tm.result(tst)), float(jm.result(jst)), rtol=RTOL,
                                   err_msg=cls)
        # pre-sorted relevance needs the counts, as in the JAX package
        with pytest.raises(ValueError, match="label_relevant_counts"):
            getattr(T, cls)(5, pre_sorted=True).update(
                tm.init_state(), torch.from_numpy(s), torch.from_numpy(t))


def test_clamped_key_over_fewer_candidates_than_k():
    s, t = _scores(8, 12, 8, ties=False)
    jagg, tagg = J.TopKMetricsAggregator.default(10), T.TopKMetricsAggregator.default(10)
    with pytest.warns(UserWarning, match="only 8 candidates"):
        tres = tagg.result(tagg.update(tagg.init_state(), torch.from_numpy(s),
                                       torch.from_numpy(t)))
    with pytest.warns(UserWarning):
        jres = jagg.result(jagg.update(jagg.init_state(), jnp.asarray(s), jnp.asarray(t)))
    assert sorted(tres) == sorted(jres)
    assert "recall_at_10_clamped_at_8" in tres
    for key in jres:
        np.testing.assert_allclose(float(tres[key]), float(jres[key]), rtol=RTOL, err_msg=key)


def test_metric_registry_parses_the_jax_names():
    for name, cls in (("recall_at", T.RecallAt), ("precision_at", T.PrecisionAt),
                      ("map_at", T.AvgPrecisionAt), ("ndcg_at", T.NDCGAt), ("mrr_at", T.MRRAt)):
        m = Metric.parse(name)
        assert type(m) is cls and m.k == 10 and m.name == f"{name}_10"
    agg = T.TopKMetricsAggregator.default(5)
    assert Metric.parse(agg) is agg
    with pytest.raises(KeyError, match="recall_at_10"):
        Metric.parse("recall_at_10")
