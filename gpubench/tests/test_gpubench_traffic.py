"""The seeded generators: the same seed gives the same rows, the draws keep
the program's sampler's domains and skew, and the row order of a shuffled
fit is the program's."""

import json

import numpy as np

from conftest import BIG_SEED, ROOT
from gpubench import retrieval, traffic

TT = json.loads((ROOT / "gpubench/configs/two_tower_ml25m.json").read_text())


def draw(seed, n=1000):
    return traffic.draw_columns(TT["columns"], n, np.random.default_rng(seed), 0.75)


def test_same_seed_same_rows():
    a, b = draw(BIG_SEED), draw(BIG_SEED)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    c = draw(BIG_SEED + 1)
    assert not np.array_equal(a["userId"], c["userId"])


def test_domains_and_lists():
    d = draw(7, 20000)
    assert d["movieId"].min() >= 1 and d["movieId"].max() <= 56680
    lengths = np.diff(d["genres__offsets"])
    assert lengths.min() == 5 and lengths.max() == 10
    assert d["genres__values"].min() >= 1 and d["genres__values"].max() <= 20
    assert d["TE_movieId_rating"].dtype == np.float32


def test_skew_follows_the_power_law():
    ids = traffic.IdSampler(1000, 0.75)(400_000, np.random.default_rng(3))
    counts = np.bincount(ids, minlength=1001)
    # P(id) ~ (id + 1) ** -0.75: ids 1 and 15 differ by (16 / 2) ** 0.75
    ratio = counts[1] / counts[15]
    assert abs(ratio - 8 ** 0.75) < 0.15 * 8 ** 0.75
    assert counts[0] == 0


def test_fit_order_is_the_programs():
    import models_tpu_torch as mt

    loader = mt.Loader(mt.generate_data("movielens-25m", num_rows=96, seed=1), 32,
                       shuffle=True, drop_last=True)
    got = np.concatenate([x["userId"] for x, _ in loader])
    in_order = next(iter(mt.Loader(mt.generate_data("movielens-25m", num_rows=96, seed=1), 96)))
    want = in_order[0]["userId"][traffic.fit_order(96)]
    assert np.array_equal(got, want)


def test_catalog_and_queries_repeat():
    a = retrieval.draw_catalog(TT, np.random.default_rng(BIG_SEED), 0.75)
    b = retrieval.draw_catalog(TT, np.random.default_rng(BIG_SEED), 0.75)
    assert np.array_equal(a["movieId"], np.arange(56681))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    q = retrieval.draw_queries(TT, 100, np.random.default_rng(BIG_SEED), 0.75)
    assert set(q) == {"userId", "userId_count"}


def test_rank_metrics_by_hand():
    m = retrieval.rank_metrics(np.array([1, 2, 11, 10]), 10)
    assert m["recall_at_10"] == 0.75
    assert abs(m["mrr_at_10"] - (1 + 0.5 + 0.1) / 4) < 1e-12
    assert abs(m["ndcg_at_10"] - (1 + 1 / np.log2(3) + 1 / np.log2(11)) / 4) < 1e-12


def test_corpus_index_is_one_for_every_seed():
    """The evaluation's catalog and weights come from the traffic's
    ``index_seed``, its queries and label ranks from the run's seed."""
    import torch

    from conftest import small_cell

    cell = small_cell("tt_corpus_eval")
    cell.traffic["queries"] = 64
    reference, entry = cell.module("reference"), cell.entry()
    a = entry.draw(cell.config, cell.traffic, reference, BIG_SEED, torch.device("cpu"))
    b = entry.draw(cell.config, cell.traffic, reference, BIG_SEED + 1, torch.device("cpu"))
    assert all(np.array_equal(a[0][k], b[0][k]) for k in a[0])
    assert not np.array_equal(a[1]["userId"], b[1]["userId"])
