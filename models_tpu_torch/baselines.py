"""Host baseline adapters (``models_tpu/baselines.py``): implicit (ALS,
BPR) and LightFM (reference ``merlin/models/implicit/__init__.py:40-217``
and ``merlin/models/lightfm/__init__.py:41``).

The Dataset → sparse user-item matrix conversion is numpy and scipy. The
model classes use the optional libraries when installed and otherwise the
built-in numpy engines of the same algorithms (implicit-feedback ALS per
Hu/Koren/Volinsky 2008, SGD BPR per Rendle 2009, a WARP-style sampled
ranker per Weston 2011). They run on the host, as in the JAX package, and
take no ``device=``.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np

from .data.dataset import Dataset
from .schema import Schema, Tags


def dataset_to_coo(dataset: Dataset, schema: Optional[Schema] = None,
                   value_column: Optional[str] = None):
    """(user, item[, value]) rows → scipy COO interaction matrix."""
    from scipy.sparse import coo_matrix

    schema = schema or dataset.schema
    cols = dataset.to_numpy_dict()
    user_col = schema.user_id_column
    item_col = schema.item_id_column
    users = cols[user_col.name].astype(np.int64)
    items = cols[item_col.name].astype(np.int64)
    if value_column and value_column in cols:
        vals = cols[value_column].astype(np.float32)
    else:
        vals = np.ones(len(users), np.float32)
    shape = (user_col.cardinality, item_col.cardinality)
    return coo_matrix((vals, (users, items)), shape=shape)


# ---------------------------------------------------------------------------
# Pure-numpy engines (used when the optional libraries are not installed).
# ---------------------------------------------------------------------------


class _NumpyALS:
    """Implicit-feedback ALS (Hu/Koren/Volinsky 2008): confidence C=1+alpha*r,
    per-user/item ridge solves against the other factor matrix."""

    def __init__(self, factors: int = 32, regularization: float = 0.01,
                 iterations: int = 15, alpha: float = 10.0, random_state: int = 0,
                 **_ignored):
        self.factors = int(factors)
        self.reg = float(regularization)
        self.iterations = int(iterations)
        self.alpha = float(alpha)
        self.random_state = int(random_state)
        self.user_factors = None
        self.item_factors = None

    @staticmethod
    def _solve_side(X_other, csr, alpha, reg, f):
        """Solve all rows of one side given the other side's factors."""
        YtY = X_other.T @ X_other + reg * np.eye(f, dtype=np.float64)
        out = np.zeros((csr.shape[0], f), dtype=np.float64)
        indptr, indices, data = csr.indptr, csr.indices, csr.data
        for u in range(csr.shape[0]):
            lo, hi = indptr[u], indptr[u + 1]
            if lo == hi:
                continue
            idx = indices[lo:hi]
            conf = 1.0 + alpha * data[lo:hi].astype(np.float64)
            Y = X_other[idx]  # (nnz, f)
            A = YtY + (Y * (conf - 1.0)[:, None]).T @ Y
            b = (Y * conf[:, None]).sum(axis=0)
            out[u] = np.linalg.solve(A, b)
        return out

    def fit(self, user_items_csr):
        rng = np.random.default_rng(self.random_state)
        n_users, n_items = user_items_csr.shape
        f = self.factors
        self.user_factors = rng.standard_normal((n_users, f)) * 0.01
        self.item_factors = rng.standard_normal((n_items, f)) * 0.01
        csr = user_items_csr.tocsr()
        csc = user_items_csr.T.tocsr()
        for _ in range(self.iterations):
            self.user_factors = self._solve_side(self.item_factors, csr, self.alpha, self.reg, f)
            self.item_factors = self._solve_side(self.user_factors, csc, self.alpha, self.reg, f)
        return self

    def recommend(self, userid, user_items_row, N=10, filter_already_liked_items=False):
        scores = self.user_factors[userid] @ self.item_factors.T
        if filter_already_liked_items:
            scores[user_items_row.indices] = -np.inf
        top = np.argpartition(-scores, min(N, len(scores) - 1))[:N]
        top = top[np.argsort(-scores[top])]
        return top, scores[top]


class _NumpyBPR:
    """SGD BPR (Rendle 2009) with vectorized minibatch triplet updates."""

    def __init__(self, factors: int = 32, learning_rate: float = 0.05,
                 regularization: float = 0.002, iterations: int = 60,
                 random_state: int = 0, **_ignored):
        self.factors = int(factors)
        self.lr = float(learning_rate)
        self.reg = float(regularization)
        self.iterations = int(iterations)
        self.random_state = int(random_state)
        self.user_factors = None
        self.item_factors = None

    def fit(self, user_items_csr):
        rng = np.random.default_rng(self.random_state)
        coo = user_items_csr.tocoo()
        users, items = coo.row, coo.col
        n_users, n_items = coo.shape
        f = self.factors
        U = rng.standard_normal((n_users, f)) * 0.1
        V = rng.standard_normal((n_items, f)) * 0.1
        n = len(users)
        for _ in range(self.iterations):
            perm = rng.permutation(n)
            negs = rng.integers(0, n_items, n)
            for lo in range(0, n, 4096):
                sel = perm[lo : lo + 4096]
                u, i, j = users[sel], items[sel], negs[sel]
                x = np.einsum("bf,bf->b", U[u], V[i] - V[j])
                g = 1.0 / (1.0 + np.exp(x))  # d/dx -log sigmoid(x)
                gu = g[:, None] * (V[i] - V[j]) - self.reg * U[u]
                gi = g[:, None] * U[u] - self.reg * V[i]
                gj = -g[:, None] * U[u] - self.reg * V[j]
                # scatter-add (duplicate rows within a minibatch accumulate)
                np.add.at(U, u, self.lr * gu)
                np.add.at(V, i, self.lr * gi)
                np.add.at(V, j, self.lr * gj)
        self.user_factors, self.item_factors = U, V
        return self

    recommend = _NumpyALS.recommend


class _NumpyWARP(_NumpyBPR):
    """WARP-style ranker (Weston 2011): for each positive, sample negatives
    until one violates the margin; weight the update by log(rank estimate)."""

    def __init__(self, factors: int = 32, learning_rate: float = 0.05,
                 regularization: float = 0.002, iterations: int = 60,
                 max_trials: int = 10, random_state: int = 0, **_ignored):
        super().__init__(factors, learning_rate, regularization, iterations, random_state)
        self.max_trials = int(max_trials)

    def fit(self, user_items_csr):
        rng = np.random.default_rng(self.random_state)
        coo = user_items_csr.tocoo()
        users, items = coo.row, coo.col
        n_users, n_items = coo.shape
        f = self.factors
        U = rng.standard_normal((n_users, f)) * 0.1
        V = rng.standard_normal((n_items, f)) * 0.1
        n = len(users)
        for _ in range(self.iterations):
            perm = rng.permutation(n)
            for lo in range(0, n, 4096):
                sel = perm[lo : lo + 4096]
                u, i = users[sel], items[sel]
                pos = np.einsum("bf,bf->b", U[u], V[i])
                # sample a panel of candidate negatives; pick the first violator
                cand = rng.integers(0, n_items, (len(sel), self.max_trials))
                neg_scores = np.einsum("bf,btf->bt", U[u], V[cand])
                viol = neg_scores > pos[:, None] - 1.0
                first = np.argmax(viol, axis=1)
                has = viol.any(axis=1)
                trials = first + 1
                # rank estimate: (n_items - 1) / trials → weight log(1+rank),
                # normalized to [0, 1] so early all-violating epochs stay stable
                w = np.log1p(np.floor((n_items - 1) / trials)) / np.log1p(n_items - 1) * has
                j = cand[np.arange(len(sel)), first]
                gu = w[:, None] * (V[i] - V[j]) - self.reg * U[u]
                gi = w[:, None] * U[u] - self.reg * V[i]
                gj = -w[:, None] * U[u] - self.reg * V[j]
                np.add.at(U, u, self.lr * gu)
                np.add.at(V, i, self.lr * gi)
                np.add.at(V, j, self.lr * gj)
        self.user_factors, self.item_factors = U, V
        return self


class _TopKEvalMixin:
    def evaluate(self, dataset: Dataset, k: int = 10) -> Dict[str, float]:
        """Per-user Recall@k / Precision@k against held-out interactions."""
        coo = dataset_to_coo(dataset, self.schema).tocsr()
        users = np.unique(coo.nonzero()[0])
        recalls, precisions = [], []
        for u in users:
            true_items = set(coo[u].indices.tolist())
            if not true_items:
                continue
            ids, _ = self.predict_user(int(u), k)
            hits = len(set(ids.tolist()) & true_items)
            recalls.append(hits / len(true_items))
            precisions.append(hits / k)
        return {
            f"recall_at_{k}": float(np.mean(recalls)) if recalls else 0.0,
            f"precision_at_{k}": float(np.mean(precisions)) if precisions else 0.0,
        }


class ImplicitModel(_TopKEvalMixin):
    """ALS / BPR via the ``implicit`` library, falling back to the built-in
    pure-numpy engines when it is not installed (same algorithms, same API)."""

    def __init__(self, schema: Schema, algo: str = "als", **params):
        self.schema = schema
        try:
            import implicit

            cls = {
                "als": implicit.als.AlternatingLeastSquares,
                "bpr": implicit.bpr.BayesianPersonalizedRanking,
            }[algo]
            self.backend = "implicit"
        except ImportError:
            cls = {"als": _NumpyALS, "bpr": _NumpyBPR}[algo]
            self.backend = "numpy"
            warnings.warn(
                "the 'implicit' library is not installed; using the built-in "
                "pure-numpy engine (same algorithm, slower on large catalogs)",
                stacklevel=2,
            )
        self.model = cls(**params)
        self._user_items = None

    def fit(self, dataset: Dataset):
        self._user_items = dataset_to_coo(dataset, self.schema).tocsr()
        self.model.fit(self._user_items)
        return self

    def predict_user(self, user_id: int, k: int = 10):
        ids, scores = self.model.recommend(
            user_id, self._user_items[user_id], N=k, filter_already_liked_items=False
        )
        return np.asarray(ids), np.asarray(scores)


class LightFMModel(_TopKEvalMixin):
    """LightFM (WARP/BPR) adapter, falling back to the built-in pure-numpy
    WARP/BPR engines when the library is not installed."""

    def __init__(self, schema: Schema, loss: str = "warp", **params):
        self.schema = schema
        self._num_items = schema.item_id_column.cardinality
        try:
            from lightfm import LightFM

            self.model = LightFM(loss=loss, **params)
            self.backend = "lightfm"
        except ImportError:
            cls = {"warp": _NumpyWARP, "bpr": _NumpyBPR}.get(loss)
            if cls is None:
                raise ValueError(
                    f"loss {loss!r} requires the lightfm library (numpy fallback "
                    "supports 'warp' and 'bpr')"
                ) from None
            self.model = cls(**params)
            self.backend = "numpy"
            warnings.warn(
                "the 'lightfm' library is not installed; using the built-in "
                "pure-numpy engine (same algorithm, slower on large catalogs)",
                stacklevel=2,
            )

    def fit(self, dataset: Dataset, epochs: int = 10):
        coo = dataset_to_coo(dataset, self.schema)
        if self.backend == "lightfm":
            self.model.fit(coo, epochs=epochs)
        else:
            self.model.iterations = epochs
            self.model.fit(coo.tocsr())
        return self

    def predict_user(self, user_id: int, k: int = 10):
        if self.backend == "lightfm":
            items = np.arange(self._num_items)
            scores = self.model.predict(user_id, items)
            top = np.argsort(-scores)[:k]
            return top, scores[top]
        from scipy.sparse import csr_matrix

        empty = csr_matrix((1, self._num_items)).getrow(0)
        ids, scores = self.model.recommend(user_id, empty, N=k)
        return np.asarray(ids), np.asarray(scores)
