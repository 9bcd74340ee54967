"""XGBoost adapter (``models_tpu/xgb.py``; reference
``merlin/models/xgb/__init__.py:36-409``): a host engine, as in the JAX
package.

Schema-driven (X, y, qid) conversion plus train/evaluate/predict behind the
MerlinModel protocol. The xgboost library is used when installed; otherwise
a built-in numpy histogram GBDT (second-order splits, quantile binning: the
algorithm family of xgboost's ``hist`` tree method) trains the same
objectives (``binary:logistic``, ``reg:squarederror``, ``rank:pairwise``).
It runs on the host's numpy and takes no ``device=``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.dataset import Dataset
from .schema import Schema, Tags


def dataset_to_xy(
    dataset: Dataset,
    schema: Optional[Schema] = None,
    target_column: Optional[str] = None,
    qid_column: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray], List[str]]:
    """Flatten a Dataset into (X, y, qid, feature_names). List columns are
    mean-pooled; the qid column (ranking objectives) defaults to USER_ID."""
    schema = schema or dataset.schema
    cols = dataset.to_numpy_dict()
    target_column = target_column or (
        schema.targets.first.name if len(schema.targets) else None
    )
    if target_column is None:
        raise ValueError("No TARGET column found for XGBoost training")

    feature_names = []
    features = []
    for col in schema:
        if col.name == target_column or col.has_tag(Tags.TARGET):
            continue
        if col.is_list:
            values = cols[col.name + "__values"].astype(np.float32)
            offsets = cols[col.name + "__offsets"]
            lengths = np.maximum(np.diff(offsets), 1)
            sums = np.add.reduceat(values, offsets[:-1])
            features.append(sums / lengths)
        else:
            features.append(cols[col.name].astype(np.float32))
        feature_names.append(col.name)
    X = np.stack(features, axis=1)
    y = cols[target_column].astype(np.float32)
    qid = None
    if qid_column is None:
        sel = schema.select_by_tag(Tags.USER_ID)
        qid_column = sel.first.name if len(sel) else None
    if qid_column is not None and qid_column in cols:
        qid = cols[qid_column]
    return X, y, qid, feature_names


# ---------------------------------------------------------------------------
# Pure-numpy histogram GBDT (fallback engine when xgboost is not installed)
# ---------------------------------------------------------------------------


class _Tree:
    """Flat-array binary tree: vectorized predict walks all rows level-wise."""

    __slots__ = ("feature", "threshold", "left", "right", "value", "is_leaf")

    def __init__(self):
        self.feature: List[int] = []
        self.threshold: List[int] = []  # bin index; go left if bin <= threshold
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[float] = []
        self.is_leaf: List[bool] = []

    def add_node(self) -> int:
        for name in self.__slots__:
            getattr(self, name).append(0)
        self.is_leaf[-1] = True
        return len(self.value) - 1

    def predict_binned(self, Xb: np.ndarray) -> np.ndarray:
        feature = np.asarray(self.feature)
        threshold = np.asarray(self.threshold)
        left, right = np.asarray(self.left), np.asarray(self.right)
        value = np.asarray(self.value)
        is_leaf = np.asarray(self.is_leaf)
        node = np.zeros(len(Xb), dtype=np.int64)
        while True:
            live = ~is_leaf[node]
            if not live.any():
                break
            rows = np.nonzero(live)[0]
            n = node[rows]
            go_left = Xb[rows, feature[n]] <= threshold[n]
            node[rows] = np.where(go_left, left[n], right[n])
        return value[node]

    def to_dict(self):
        return {name: list(getattr(self, name)) for name in self.__slots__}

    @classmethod
    def from_dict(cls, d):
        t = cls()
        for name in cls.__slots__:
            setattr(t, name, list(d[name]))
        return t


class _NumpyGBDT:
    """Second-order histogram gradient boosting (xgboost's ``hist`` recipe):
    quantile-bin features once, per round compute grad/hess for the objective,
    grow a depth-limited tree greedily on histogram split gains
    ``G_L²/(H_L+λ) + G_R²/(H_R+λ) − G²/(H+λ)``, leaf weight ``−G/(H+λ)``."""

    def __init__(self, objective: str = "binary:logistic", max_depth: int = 6,
                 learning_rate: float = 0.3, n_bins: int = 64,
                 reg_lambda: float = 1.0, min_child_weight: float = 1.0,
                 gamma: float = 0.0, **_ignored):
        self.objective = objective
        self.max_depth = int(max_depth)
        self.lr = float(learning_rate)
        self.n_bins = int(n_bins)
        self.reg_lambda = float(reg_lambda)
        self.min_child_weight = float(min_child_weight)
        self.gamma = float(gamma)
        self.trees: List[_Tree] = []
        self.bin_edges: Optional[List[np.ndarray]] = None
        self.base_score = 0.0

    # -- binning ----------------------------------------------------------
    def _fit_bins(self, X: np.ndarray) -> None:
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        self.bin_edges = [np.unique(np.quantile(X[:, f], qs)) for f in range(X.shape[1])]

    def _bin(self, X: np.ndarray) -> np.ndarray:
        Xb = np.empty(X.shape, dtype=np.int32)
        for f, edges in enumerate(self.bin_edges):
            Xb[:, f] = np.searchsorted(edges, X[:, f], side="right")
        return Xb

    # -- objectives ---------------------------------------------------------
    def _grad_hess(self, pred: np.ndarray, y: np.ndarray, qid):
        if self.objective == "reg:squarederror":
            return pred - y, np.ones_like(pred)
        if self.objective == "binary:logistic":
            p = 1.0 / (1.0 + np.exp(-pred))
            return p - y, np.maximum(p * (1.0 - p), 1e-6)
        if self.objective == "rank:pairwise":
            # RankNet-style pairwise lambdas within each query group
            g = np.zeros_like(pred)
            h = np.zeros_like(pred)
            order = np.argsort(qid, kind="stable")
            bounds = np.flatnonzero(np.r_[True, np.diff(qid[order]) != 0, True])
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                idx = order[lo:hi]
                yy, pp = y[idx], pred[idx]
                diff = yy[:, None] > yy[None, :]  # i beats j
                if not diff.any():
                    continue
                rho = 1.0 / (1.0 + np.exp(pp[:, None] - pp[None, :]))  # P(miss-order)
                lam = rho * diff
                hij = (rho * (1 - rho)) * diff
                g[idx] += -lam.sum(axis=1) + lam.sum(axis=0)
                h[idx] += hij.sum(axis=1) + hij.sum(axis=0)
            return g, np.maximum(h, 1e-6)
        raise ValueError(f"Unsupported objective {self.objective!r} in numpy fallback")

    # -- tree growth --------------------------------------------------------
    def _grow(self, Xb: np.ndarray, g: np.ndarray, h: np.ndarray) -> _Tree:
        tree = _Tree()
        root = tree.add_node()
        n_bins = self.n_bins
        lam = self.reg_lambda

        def leaf_weight(gs, hs):
            return -gs / (hs + lam)

        # (node_id, row_index_array, depth)
        stack = [(root, np.arange(len(Xb)), 0)]
        while stack:
            nid, rows, depth = stack.pop()
            gs, hs = g[rows].sum(), h[rows].sum()
            tree.value[nid] = leaf_weight(gs, hs)
            if depth >= self.max_depth or len(rows) < 2:
                continue
            parent_score = gs * gs / (hs + lam)
            best = (self.gamma, -1, -1)  # (gain, feature, threshold_bin)
            Xr = Xb[rows]
            for f in range(Xb.shape[1]):
                gh = np.bincount(Xr[:, f], weights=g[rows], minlength=n_bins)
                hh = np.bincount(Xr[:, f], weights=h[rows], minlength=n_bins)
                gl, hl = np.cumsum(gh)[:-1], np.cumsum(hh)[:-1]
                gr, hr = gs - gl, hs - hl
                ok = (hl >= self.min_child_weight) & (hr >= self.min_child_weight)
                gain = np.where(
                    ok,
                    gl * gl / (hl + lam) + gr * gr / (hr + lam) - parent_score,
                    -np.inf,
                )
                b = int(np.argmax(gain))
                if gain[b] > best[0]:
                    best = (float(gain[b]), f, b)
            if best[1] < 0:
                continue
            _, f, b = best
            go_left = Xr[:, f] <= b
            lid, rid = tree.add_node(), tree.add_node()
            tree.is_leaf[nid] = False
            tree.feature[nid], tree.threshold[nid] = f, b
            tree.left[nid], tree.right[nid] = lid, rid
            stack.append((lid, rows[go_left], depth + 1))
            stack.append((rid, rows[~go_left], depth + 1))
        return tree

    # -- public -------------------------------------------------------------
    def fit(self, X, y, qid=None, num_boost_round: int = 50):
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self._fit_bins(X)
        Xb = self._bin(X)
        if self.objective == "binary:logistic":
            p = np.clip(y.mean(), 1e-6, 1 - 1e-6)
            self.base_score = float(np.log(p / (1 - p)))
        elif self.objective == "reg:squarederror":
            self.base_score = float(y.mean())
        else:
            self.base_score = 0.0
        pred = np.full(len(y), self.base_score, dtype=np.float64)
        self.trees = []
        for _ in range(num_boost_round):
            g, h = self._grad_hess(pred, y, qid)
            tree = self._grow(Xb, g, h)
            pred += self.lr * tree.predict_binned(Xb)
            self.trees.append(tree)
        return self

    def predict_raw(self, X) -> np.ndarray:
        Xb = self._bin(np.asarray(X, np.float32))
        out = np.full(len(Xb), self.base_score, dtype=np.float64)
        for tree in self.trees:
            out += self.lr * tree.predict_binned(Xb)
        return out

    def predict(self, X) -> np.ndarray:
        raw = self.predict_raw(X)
        if self.objective == "binary:logistic":
            return 1.0 / (1.0 + np.exp(-raw))
        return raw

    def eval_metrics(self, X, y, qid=None) -> Dict[str, float]:
        pred = self.predict(X)
        if self.objective == "binary:logistic":
            p = np.clip(pred, 1e-7, 1 - 1e-7)
            return {"logloss": float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))}
        if self.objective == "reg:squarederror":
            return {"rmse": float(np.sqrt(np.mean((pred - y) ** 2)))}
        # rank: mean average precision over query groups (binary relevance)
        aps = []
        order = np.argsort(qid, kind="stable")
        bounds = np.flatnonzero(np.r_[True, np.diff(qid[order]) != 0, True])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            idx = order[lo:hi]
            rel = y[idx] > 0
            if not rel.any():
                continue
            rank = np.argsort(-pred[idx])
            hits = rel[rank]
            prec = np.cumsum(hits) / (np.arange(len(hits)) + 1)
            aps.append((prec * hits).sum() / hits.sum())
        return {"map": float(np.mean(aps)) if aps else 0.0}

    def save_model(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "engine": "models_tpu-numpy-gbdt",
                    "objective": self.objective,
                    "learning_rate": self.lr,
                    "base_score": self.base_score,
                    "bin_edges": [e.tolist() for e in self.bin_edges],
                    "trees": [t.to_dict() for t in self.trees],
                },
                f,
            )

    @classmethod
    def load_model(cls, path: str) -> "_NumpyGBDT":
        with open(path) as f:
            d = json.load(f)
        m = cls(objective=d["objective"], learning_rate=d["learning_rate"])
        m.base_score = d["base_score"]
        m.bin_edges = [np.asarray(e) for e in d["bin_edges"]]
        m.trees = [_Tree.from_dict(t) for t in d["trees"]]
        return m


class XGBoost:
    """Train XGBoost on a schema'd Dataset (objectives incl. ``rank:*`` which sort
    by qid as xgboost requires, mirroring the reference's qid handling). Falls
    back to the built-in numpy histogram GBDT when xgboost is not installed."""

    def __init__(self, schema: Schema, objective: str = "binary:logistic",
                 target_column: Optional[str] = None, **params):
        try:
            import xgboost  # noqa: F401

            self.backend = "xgboost"
        except ImportError:
            self.backend = "numpy"
            warnings.warn(
                "xgboost is not installed; using the built-in numpy histogram "
                "GBDT (same hist algorithm, slower at scale)",
                stacklevel=2,
            )
        self.schema = schema
        self.objective = objective
        self.target_column = target_column
        self.params = {"objective": objective, **params}
        self.booster = None

    def _dmatrix(self, dataset: Dataset):
        import xgboost as xgb

        X, y, qid, names = dataset_to_xy(dataset, self.schema, self.target_column)
        if self.objective.startswith("rank"):
            order = np.argsort(qid, kind="stable")
            X, y, qid = X[order], y[order], qid[order]
            return xgb.DMatrix(X, label=y, qid=qid, feature_names=names)
        return xgb.DMatrix(X, label=y, feature_names=names)

    def _xy(self, dataset: Dataset):
        X, y, qid, names = dataset_to_xy(dataset, self.schema, self.target_column)
        if self.objective.startswith("rank") and qid is not None:
            order = np.argsort(qid, kind="stable")
            X, y, qid = X[order], y[order], qid[order]
        return X, y, qid, names

    def fit(self, dataset: Dataset, num_boost_round: int = 50, evals=None, **kwargs):
        if self.backend == "numpy":
            X, y, qid, _ = self._xy(dataset)
            self.booster = _NumpyGBDT(**self.params).fit(
                X, y, qid=qid, num_boost_round=num_boost_round
            )
            return self
        import xgboost as xgb

        dtrain = self._dmatrix(dataset)
        evals = [(self._dmatrix(d), name) for d, name in (evals or [])]
        self.booster = xgb.train(
            self.params, dtrain, num_boost_round=num_boost_round, evals=evals, **kwargs
        )
        return self

    def evaluate(self, dataset: Dataset) -> Dict[str, float]:
        if self.backend == "numpy":
            X, y, qid, _ = self._xy(dataset)
            return self.booster.eval_metrics(X, y, qid=qid)
        dmat = self._dmatrix(dataset)
        raw = self.booster.eval(dmat)
        out = {}
        for part in raw.split("\t")[1:]:
            name, value = part.split(":")
            out[name] = float(value)
        return out

    def predict(self, dataset: Dataset) -> np.ndarray:
        if self.backend == "numpy":
            X, _, _, _ = self._xy(dataset)
            return self.booster.predict(X)
        return self.booster.predict(self._dmatrix(dataset))

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.booster.save_model(os.path.join(path, "model.json"))
        self.schema.save(os.path.join(path, "schema.json"))

    @classmethod
    def load(cls, path: str) -> "XGBoost":
        """Restore a saved adapter (numpy-GBDT json or an xgboost booster)."""
        from .schema import Schema

        schema = Schema.load(os.path.join(path, "schema.json"))
        model_path = os.path.join(path, "model.json")
        with open(model_path) as f:
            head = f.read(64)
        if "models_tpu-numpy-gbdt" in head:
            booster = _NumpyGBDT.load_model(model_path)
            self = cls.__new__(cls)
            self.backend = "numpy"
            self.schema = schema
            self.objective = booster.objective
            self.target_column = None
            self.params = {"objective": booster.objective}
            self.booster = booster
            return self
        import xgboost as xgb

        self = cls.__new__(cls)
        self.backend = "xgboost"
        self.schema = schema
        self.target_column = None
        booster = xgb.Booster()
        booster.load_model(model_path)
        self.booster = booster
        # objective recovered from booster config
        cfg = json.loads(booster.save_config())
        self.objective = (
            cfg.get("learner", {}).get("objective", {}).get("name", "binary:logistic")
        )
        self.params = {"objective": self.objective}
        return self
