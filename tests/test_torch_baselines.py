"""The port's host engines (``models_tpu_torch/xgb.py``, ``baselines.py``)
against the JAX package's, on the same inputs: ``tests/unit/test_backends.py``'s
xgb, COO, implicit and lightfm cases (``:88-330``) give bit-equal results in
both packages (both are numpy, neither touches a device), and
``examples/12_traditional_ml_baselines.py`` runs on the port's names (its
source read with ``models_tpu`` as ``models_tpu_torch``)."""

import re
import warnings
from pathlib import Path

import numpy as np
import pytest

import models_tpu as mm
import models_tpu.baselines as jbase
import models_tpu.xgb as jxgb
import models_tpu_torch as mt
import models_tpu_torch.baselines as tbase
import models_tpu_torch.xgb as txgb

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": (mm, jxgb, jbase), "port": (mt, txgb, tbase)}


def both(fn):
    """``fn(pkg, xgb, baselines)`` on each package, warnings silenced."""
    out = {}
    for name, mods in PACKAGES.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out[name] = fn(*mods)
    return out["port"], out["jax"]


def equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _blocky(pkg, n_users=60, n_items=80, per_user=12, seed=0):  # test_backends.py:174
    rng = np.random.default_rng(seed)
    users, items = [], []
    for u in range(n_users):
        lo, hi = (0, n_items // 2) if u < n_users // 2 else (n_items // 2, n_items)
        users.extend([u] * per_user)
        items.extend(rng.choice(np.arange(lo, hi), size=per_user, replace=False).tolist())
    schema = pkg.Schema([
        pkg.create_categorical_column("user_id", n_users, tags=(pkg.Tags.USER, pkg.Tags.USER_ID)),
        pkg.create_categorical_column("item_id", n_items, tags=(pkg.Tags.ITEM, pkg.Tags.ITEM_ID)),
    ])
    return pkg.Dataset({"user_id": np.asarray(users, np.int64),
                        "item_id": np.asarray(items, np.int64)}, schema=schema)


def case_xgb_dataset_conversion(pkg, xgb, base):  # :88
    X, y, qid, names = xgb.dataset_to_xy(pkg.generate_data("music-streaming", num_rows=256),
                                         target_column="click")
    return [X, y, qid, names]


def case_coo_conversion(pkg, xgb, base):  # :97
    coo = base.dataset_to_coo(pkg.generate_data("movielens-100k", num_rows=100))
    return [coo.shape, coo.row, coo.col, coo.data]


def case_implicit_als(pkg, xgb, base):  # :192
    model = base.ImplicitModel(_blocky(pkg).schema, algo="als", factors=16, iterations=10)
    ds = _blocky(pkg)
    model.fit(ds)
    return [model.backend, model.evaluate(ds, k=10), model.predict_user(0, k=10)]


def case_implicit_bpr(pkg, xgb, base):  # :192
    model = base.ImplicitModel(_blocky(pkg).schema, algo="bpr", factors=16, iterations=10)
    ds = _blocky(pkg)
    model.fit(ds)
    return [model.evaluate(ds, k=10), model.predict_user(0, k=10)]


@pytest.mark.parametrize("loss", ["warp", "bpr"])
def test_lightfm_numpy_engine(loss):  # :214
    def run(pkg, xgb, base):
        ds = _blocky(pkg, seed=1)
        model = base.LightFMModel(ds.schema, loss=loss, factors=16)
        model.fit(ds, epochs=10)
        return [model.backend, model.evaluate(ds, k=10), model.predict_user(59, k=10)]

    got, want = both(run)
    equal(got, want)


def case_gbdt_logistic_xor(pkg, xgb, base):  # :229
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (800, 4)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    m = xgb._NumpyGBDT("binary:logistic", max_depth=3, learning_rate=0.3)
    m.fit(X[:600], y[:600], num_boost_round=15)
    return [m.predict(X[600:]), m.eval_metrics(X[600:], y[600:])]


def case_gbdt_regression_and_save_load(pkg, xgb, base, tmp):  # :245
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    y = (np.sin(6 * X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    m = xgb._NumpyGBDT("reg:squarederror", max_depth=4)
    m.fit(X, y, num_boost_round=15)
    path = str(tmp / f"{xgb.__name__}.json")
    m.save_model(path)
    m2 = xgb._NumpyGBDT.load_model(path)
    np.testing.assert_array_equal(m2.predict(X[:50]), m.predict(X[:50]))
    return [m.eval_metrics(X, y), m2.predict(X[:50]), Path(path).read_text()]


def _click_data(pkg, n=600, seed=2):
    rng = np.random.default_rng(seed)
    age = rng.uniform(0, 1, n).astype(np.float32)
    cat = rng.integers(0, 5, n)
    click = ((age > 0.5) & (cat % 2 == 0)).astype(np.float32)
    schema = pkg.Schema([
        pkg.create_continuous_column("age"),
        pkg.create_categorical_column("cat", 5),
        pkg.create_continuous_column("click", tags=(pkg.Tags.TARGET,)),
    ])
    return pkg.Dataset({"age": age, "cat": cat, "click": click}, schema=schema), schema


def case_xgb_adapter_end_to_end(pkg, xgb, base, tmp):  # :262
    ds, schema = _click_data(pkg)
    model = xgb.XGBoost(schema, objective="binary:logistic", max_depth=3)
    model.fit(ds, num_boost_round=10)
    model.save(str(tmp / xgb.__name__))
    m2 = xgb.XGBoost.load(str(tmp / xgb.__name__))
    return [model.backend, model.evaluate(ds), model.predict(ds), m2.predict(ds), m2.objective]


def case_gbdt_rank_pairwise(pkg, xgb, base):  # :293
    rng = np.random.default_rng(3)
    n = 600
    qid = np.sort(rng.integers(0, 40, n))
    X = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rel = (X[:, 0] + 0.3 * X[:, 1] > 0.8).astype(np.float32)
    m = xgb._NumpyGBDT("rank:pairwise", max_depth=3, learning_rate=0.2)
    m.fit(X, rel, qid=qid, num_boost_round=10)
    return [m.eval_metrics(X, rel, qid=qid), m.predict(X)]


CASES = {n[len("case_"):]: f for n, f in globals().items() if n.startswith("case_")}
NEEDS_TMP = {"gbdt_regression_and_save_load", "xgb_adapter_end_to_end"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_engines_bit_equal(case, tmp_path):
    fn = CASES[case]
    if case in NEEDS_TMP:
        got, want = both(lambda *m: fn(*m, tmp_path))
    else:
        got, want = both(fn)
    equal(got, want)


def test_the_engines_warn_as_jax_does_and_keep_the_protocol():
    ds, schema = _click_data(mt)
    with pytest.warns(UserWarning, match="numpy histogram"):
        model = txgb.XGBoost(schema, objective="binary:logistic", max_depth=3)
    assert model.backend == "numpy" and isinstance(model, mt.MerlinModel)
    with pytest.warns(UserWarning, match="pure-numpy"):
        als = tbase.ImplicitModel(_blocky(mt).schema, algo="als")
    assert als.backend == "numpy"


def test_example_12_on_the_port_names():
    """``examples/12_traditional_ml_baselines.py`` with ``models_tpu`` read as
    ``models_tpu_torch``, at fewer rows; its printed metrics equal the JAX
    package's run of the same source."""
    src = (ROOT / "examples" / "12_traditional_ml_baselines.py").read_text()
    src = src.replace("num_rows=1500", "num_rows=300").replace("num_rows=400", "num_rows=120")
    outputs = {}
    for name in ("models_tpu", "models_tpu_torch"):
        code = re.sub(r"\bmodels_tpu\b", name, src)
        lines = []
        scope = {"print": lambda *a: lines.append(a)}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            exec(compile(code, f"example_12[{name}]", "exec"), scope)
        outputs[name] = lines
    assert [line[0] for line in outputs["models_tpu_torch"]] == ["xgboost:", "als:", "warp:"]
    equal([line[1] for line in outputs["models_tpu_torch"]],
          [line[1] for line in outputs["models_tpu"]])
