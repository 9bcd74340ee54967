"""The port's data plane against the JAX package's, on the CPU: the
synthetic schemas and ``generate_data(set_sizes=)``, the ``Dataset`` methods,
the preprocessing ops and ``Workflow`` of ``data/workflow.py``, the named
getters of ``data/datasets.py`` (``get_movielens(path)`` on tiny raw
ml-100k, ml-1m and ml-25m layouts written here, read by JAX through pandas;
the other raw layouts are in ``test_torch_raw_datasets.py``),
and ``examples/09``'s flow on the port's names. Datasets are held equal
column by column (``to_numpy_dict``: values and dtypes, strings hashed as
both packages hash them; a list column's values of one kind, since the JAX
package's arrow lists widen them to 64 bits) with their schemas
(``Schema.to_dict``). The fits
of example 09 agree within rtol 2e-4 (the mesh tests' tolerance: the same
function, float32 sums in other orders). Example 06's flow runs on a
four-rank mesh in ``test_torch_mesh_breadth.py``.

Reductions: 300 rows a registry name; example 09 at 2,000 raw rows (its own
10,000) and one epoch of batch 256. The JAX DLRM's binary head trains with
``softplus(x) - x y`` (its ``binary_crossentropy`` has a wrong gradient at
a zero logit: ROADMAP.md queue 3).
"""

import os

import jax
import numpy as np
import pytest
from flax import nnx

import models_tpu as mm
import models_tpu.losses as jlosses
from models_tpu.data import datasets as jdatasets
from models_tpu.data import generate_data as jax_generate
from models_tpu.data import workflow as jwf
from models_tpu.data.synthetic import KNOWN_DATASETS as JAX_KNOWN
from models_tpu.schema import ColumnSchema as JCol
from models_tpu.schema import Schema as JSchema
from models_tpu.schema import create_continuous_column as jcont

import models_tpu_torch as mt
from models_tpu_torch.data import datasets as tdatasets
from models_tpu_torch.data import workflow as twf
from models_tpu_torch.schema import ColumnSchema as TCol
from models_tpu_torch.schema import Schema as TSchema
from models_tpu_torch.schema import create_continuous_column as tcont

RTOL = 2e-4


def assert_same_data(tds, jds, what=""):
    """Columns (values and dtypes) and schemas equal."""
    want, got = jds.to_numpy_dict(), tds.to_numpy_dict()
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        v = np.asarray(v)
        if k.endswith("__values"):  # JAX's arrow lists widen to 64 bits
            assert got[k].dtype.kind == v.dtype.kind, (what, k, got[k].dtype, v.dtype)
        else:
            assert got[k].dtype == v.dtype, (what, k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what}: {k}")
    assert tds.schema.to_dict() == jds.schema.to_dict(), what
    assert tds.column_names == list(jds.column_names), what


# ---- synthetic schemas ------------------------------------------------------

def test_the_registry_has_every_jax_name():
    assert sorted(mt.data.KNOWN_DATASETS) == sorted(JAX_KNOWN)
    assert len(JAX_KNOWN) == 20


@pytest.mark.parametrize("name", sorted(JAX_KNOWN))
def test_generate_data_matches_jax(name):
    kw = dict(num_rows=300, seed=11)
    assert_same_data(mt.generate_data(name, **kw), jax_generate(name, **kw), name)


@pytest.mark.parametrize("sizes", [(0.8, 0.2), (0.5, 0.3, 0.2)])
def test_set_sizes_split_matches_jax(sizes):
    kw = dict(num_rows=257, set_sizes=sizes, seed=5)
    tparts, jparts = mt.generate_data("music-streaming", **kw), jax_generate("music-streaming",
                                                                             **kw)
    assert len(tparts) == len(jparts) == len(sizes)
    for i, (t, j) in enumerate(zip(tparts, jparts)):
        assert_same_data(t, j, f"part {i}")


def test_dataset_methods_match_jax():
    """shuffle, head, select_columns and partitions (JAX returns an arrow
    table from ``head`` and ``partitions``; the port its own Dataset)."""
    kw = dict(num_rows=64, seed=3)
    t, j = mt.generate_data("testing", **kw), jax_generate("testing", **kw)
    assert_same_data(t.shuffle(seed=9), j.shuffle(seed=9), "shuffle")
    head = t.head(7)
    assert isinstance(head, mt.Dataset)
    assert_same_data(head, mm.data.Dataset(j.head(7), schema=j.schema), "head")
    names = ["categories", "user_id", "item_age_days_norm"]
    assert_same_data(t.select_columns(names), j.select_columns(names), "select_columns")
    parts = list(t.partitions())
    assert len(parts) == len(list(j.partitions())) == 1
    assert_same_data(parts[0], j, "partitions")
    with pytest.raises(KeyError):
        t.select_columns(["nope"])


def test_string_columns_stay_strings_in_the_table():
    """A string column keeps its values for a workflow and hands the
    loader JAX's hashes."""
    data = {"name": np.array(["b", "a", "b", "c"]), "x": np.arange(4)}
    t, j = mt.Dataset(data), mm.data.Dataset(data)
    assert list(t.columns()["name"]) == ["b", "a", "b", "c"]
    np.testing.assert_array_equal(t.to_numpy_dict()["name"], j.to_numpy_dict()["name"])
    assert t.unique_by("name").num_rows == 3


# ---- workflow ops -----------------------------------------------------------

def raw_frame(n=400, seed=0):
    rng = np.random.default_rng(seed)
    data = {
        "user": rng.integers(1000, 1040, n),
        "item": rng.choice(np.array(["a", "b", "c", "d", "e", "f"]), n,
                           p=[.3, .2, .2, .1, .1, .1]),
        "rating": rng.integers(1, 6, n).astype(np.float64),
        "age": rng.uniform(5, 85, n).astype(np.float32),
        "price": rng.normal(3, 2, n).astype(np.float32),
    }
    cols = [("user", "int64"), ("item", "bytes"), ("rating", None), ("age", None),
            ("price", None)]

    def schema(col_cls, cont):
        return [col_cls(c, dtype=d) if d else cont(c) for c, d in cols]

    jschema = JSchema(schema(JCol, jcont))
    tschema = TSchema(schema(TCol, tcont))
    return data, jschema, tschema


def op_pairs():
    ext = {"item": np.array(["a", "b", "c", "z"]), "brand": np.array([3, 1, 2, 9]),
           "weight": np.array([0.5, 1.5, 2.5, 9.0])}
    return {
        "categorify": lambda m: m.Categorify(["user", "item"]),
        "categorify_capped": lambda m: m.Categorify(["item"], freq_threshold=41, max_size=4),
        "target_encoding": lambda m: m.TargetEncoding("item", target="rating", kfold=3,
                                                      p_smooth=5.0, tags="item"),
        "target_encoding_raw": lambda m: m.TargetEncoding("user", target="rating",
                                                          normalize=False, out="te"),
        "groupby_count": lambda m: m.GroupbyCount("user", log=True),
        "groupby_count_plain": lambda m: m.GroupbyCount("item", log=False, out="n_item"),
        "bucketize": lambda m: m.Bucketize({"age": [0, 18, 35, 65]}, tags="user"),
        "normalize": lambda m: m.Normalize(["price", "age"]),
        "join_external": lambda m: m.JoinExternal(ext, on="item", fill=-1, tags="item"),
        "lambda": lambda m: m.LambdaOp("rating", lambda v: (v > 3).astype("int32"),
                                       out="liked", tags=("binary_classification", "target"),
                                       dtype="int32"),
        "lambda_in_place": lambda m: m.LambdaOp("price", lambda v: v * 2),
        "add_tags": lambda m: m.AddTags(["user", "age"], "user"),
        "filter_rows": lambda m: m.FilterRows(lambda d: np.asarray(d["rating"]) >= 3),
    }


def assert_same_parts(got, want, what):
    (td, ts), (jd, js) = got, want
    assert list(td) == list(jd), what
    for k in jd:
        a, b = np.asarray(td[k]), np.asarray(jd[k])
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")
    assert ts.to_dict() == js.to_dict(), what


@pytest.mark.parametrize("name", sorted(op_pairs()))
def test_workflow_op_matches_jax(name):
    """Each op fitted on one split and applied to it and to another: the
    columns and the schema it emits (tags, domains, dtypes). A target
    encoding hands its fitted rows their out-of-fold values and other rows
    the full mapping."""
    make = op_pairs()[name]
    data, jschema, tschema = raw_frame()
    other, _, _ = raw_frame(n=150, seed=1)
    jop, top = make(jwf), make(twf)
    jop.fit(data, jschema)
    top.fit(data, tschema)
    for tag, d in (("fitted", data), ("other", other)):
        assert_same_parts(top.transform(d, tschema), jop.transform(d, jschema), f"{name} {tag}")


def test_workflow_fit_transform_matches_jax():
    """``fit_transform`` then ``transform``, and ``fit`` then ``transform``
    of the fitted split (out of fold again), through Datasets."""
    data, jschema, tschema = raw_frame()
    jtrain, jvalid = mm.data.Dataset(data, schema=jschema).split([0.7, 0.3], seed=2)
    ttrain, tvalid = mt.Dataset(data, schema=tschema).split([0.7, 0.3], seed=2)

    def ops(m):
        return m.Workflow([
            m.Categorify(["user", "item"]),
            m.TargetEncoding("item", target="rating", kfold=5, p_smooth=20, tags="item"),
            m.GroupbyCount("user", log=True, tags="user"),
            m.Bucketize({"age": [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]}, tags="user"),
            m.LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                       tags=("binary_classification", "target"), dtype="int32"),
        ])

    jw, tw = ops(jwf), ops(twf)
    assert_same_data(tw.fit_transform(ttrain), jw.fit_transform(jtrain), "fit_transform")
    assert_same_data(tw.transform(tvalid), jw.transform(jvalid), "transform valid")
    jw2, tw2 = ops(jwf), ops(twf)
    jw2.fit(jtrain)
    tw2.fit(ttrain)
    assert_same_data(tw2.transform(ttrain), jw2.transform(jtrain), "transform of the fitted")
    with pytest.raises(TypeError):
        tw.transform(data)


def test_target_encoding_knows_its_fitted_string_column_again():
    """A target encoding of a raw string column hands its fitted rows their
    out-of-fold values whenever they come back. The JAX package's digest of
    an object column hashes the strings' addresses, so its later
    ``transform`` of the fitted split serves the full mapping instead
    (ROADMAP.md queue 3); the port's columns hash by content, and its
    ``transform`` equals JAX's ``fit_transform``."""
    rng = np.random.default_rng(0)
    data = {"item": np.array([f"item_number_{i}" for i in rng.integers(0, 7, 200)]),
            "rating": rng.integers(1, 6, 200).astype(np.float64)}

    def run(wf, pkg):
        ds = pkg.Dataset(data, schema=pkg.Schema([pkg.ColumnSchema("item", dtype="bytes"),
                                                  pkg.create_continuous_column("rating")]))
        w = wf.Workflow([wf.TargetEncoding("item", target="rating", kfold=3, p_smooth=5.0,
                                           normalize=False, out="te")])
        return w.fit_transform(ds).to_numpy_dict()["te"], w.transform(ds).to_numpy_dict()["te"]

    (jfit, jagain), (tfit, tagain) = run(jwf, mm), run(twf, mt)
    np.testing.assert_array_equal(tfit, jfit)
    np.testing.assert_array_equal(tagain, jfit)
    assert not np.array_equal(jagain, jfit)  # the reference's fault, as recorded


# ---- getters ----------------------------------------------------------------

@pytest.mark.parametrize("getter,kw", [
    ("get_movielens", {"variant": "ml-100k"}), ("get_movielens", {"variant": "ml-1m"}),
    ("get_movielens", {"variant": "ml-25m"}), ("get_criteo", {}), ("get_aliccp", {}),
    ("get_booking", {}), ("get_dressipi2022", {}), ("get_sigir", {"table": "browsing"}),
    ("get_sigir", {"table": "sku"}), ("get_tenrec", {}), ("get_ecommerce_transactions", {}),
])
def test_synthesized_getters_match_jax(getter, kw):
    kw = dict(kw, num_rows=120)
    for t, j in zip(getattr(tdatasets, getter)(**kw), getattr(jdatasets, getter)(**kw)):
        assert_same_data(t, j, getter)


def write(path, name, lines, encoding="utf-8"):
    with open(os.path.join(path, name), "w", encoding=encoding) as fh:
        fh.write("\n".join(lines) + "\n")


def ml100k(path, split_files=True):
    rng = np.random.default_rng(3)
    zips = ["55105", "T8H1N", "94043", "02139", "55105", "V3N4P", "10003", "94043"]
    write(path, "u.user", [f"{u}|{rng.integers(7, 70)}|{'MF'[u % 2]}|{'ab'[u % 2]}xx|"
                           f"{zips[u % len(zips)]}" for u in range(1, 25)])
    movies = []
    for m in range(1, 19):
        flags = (rng.random(19) < 0.2).astype(int)
        movies.append(f"{m}|Movie {m} (199{m % 10})|01-Jan-199{m % 10}||http://x/{m}|"
                      + "|".join(map(str, flags)))
    write(path, "u.item", movies, encoding="latin1")
    lines = [f"{rng.integers(1, 25)}\t{rng.integers(1, 19)}\t{rng.integers(1, 6)}\t"
             f"{880000000 + i}" for i in range(160)]
    if split_files:
        write(path, "ua.base", lines[:120])
        write(path, "ua.test", lines[120:])
    else:
        write(path, "u.data", lines)


def ml1m(path):
    rng = np.random.default_rng(4)
    genres = ["Action", "Comedy", "Drama", "Horror", "Sci-Fi"]
    write(path, "users.dat", [f"{u}::{'MF'[u % 2]}::{[1, 18, 25, 35][u % 4]}::{u % 7}::"
                              f"{['48067', '70072', '55117', '02460-1234'][u % 4]}"
                              for u in range(1, 21)], encoding="latin1")
    write(path, "movies.dat", [f"{m}::Title {m} (2000)::"
                               + "|".join(rng.choice(genres, rng.integers(1, 4), replace=False))
                               for m in range(1, 16)], encoding="latin1")
    write(path, "ratings.dat", [f"{rng.integers(1, 21)}::{rng.integers(1, 16)}::"
                                f"{rng.integers(1, 6)}::{978300000 + i}" for i in range(150)],
          encoding="latin1")


def ml25m(path):
    rng = np.random.default_rng(5)
    genres = ["Adventure", "Animation", "Children", "Comedy", "Fantasy", "Romance", "Drama"]
    movies = ["movieId,title,genres"]
    for m in range(1, 22, 2):
        g = "|".join(rng.choice(genres, rng.integers(1, 4), replace=False))
        movies.append(f'{m},"Toy Story, part {m} (1995)",{g}' if m % 3 else
                      f"{m},Heat {m} (1995),(no genres listed)")
    write(path, "movies.csv", movies)
    write(path, "ratings.csv", ["userId,movieId,rating,timestamp"]
          + [f"{rng.integers(1, 30)},{rng.choice(np.arange(1, 24, 2))},"
             f"{rng.integers(1, 11) / 2},{1147880044 + i}" for i in range(200)])


@pytest.mark.parametrize("layout", ["ml-100k", "ml-100k-u.data", "ml-1m", "ml-25m",
                                    "ratings-only"])
def test_get_movielens_raw_layouts_match_jax(tmp_path, layout):
    """The raw layouts prepared as the JAX package prepares them with
    pandas (reads, left merges, the seeded shuffle, the workflow, the
    genres list): train and valid equal, schemas included."""
    variant = {"ml-100k-u.data": "ml-100k", "ratings-only": "ml-1m"}.get(layout, layout)
    if layout == "ml-100k":
        ml100k(str(tmp_path))
    elif layout == "ml-100k-u.data":
        ml100k(str(tmp_path), split_files=False)
    elif layout == "ml-1m":
        ml1m(str(tmp_path))
    elif layout == "ml-25m":
        ml25m(str(tmp_path))
    else:
        write(str(tmp_path), "ratings.dat", [f"{i % 9 + 1}::{i % 13 + 1}::{i % 5 + 1}::0"
                                             for i in range(60)])
    got = tdatasets.get_movielens(str(tmp_path), variant=variant)
    want = jdatasets.get_movielens(str(tmp_path), variant=variant)
    for part, t, j in zip(("train", "valid"), got, want):
        assert t.num_rows > 0
        assert_same_data(t, j, f"{layout} {part}")


def test_routes_the_port_does_not_take_raise(tmp_path):
    """Prepared parquet and every getter's raw layout are read
    (``tests/test_torch_raw_datasets.py``); what the port's codec does not
    read raises naming it (prepared parquet compressed with ZSTD), and a
    path that holds none of them synthesizes."""
    import pyarrow.parquet as pq

    train, valid = jax_generate("sigir-browsing", num_rows=40, set_sizes=(0.8, 0.2), seed=1)
    for part, ds in (("train", train), ("valid", valid)):
        os.makedirs(tmp_path / "pq" / part)
        pq.write_table(ds.to_table(), str(tmp_path / "pq" / part / "part_0.parquet"),
                       compression="zstd")
    got_train, _ = tdatasets.get_sigir(str(tmp_path / "pq"), num_rows=20)
    assert got_train.num_rows == 32  # the footer reads; the pages do not
    with pytest.raises(NotImplementedError, match="ZSTD"):
        got_train.to_numpy_dict()
    empty = tmp_path / "empty"
    os.makedirs(empty)
    for t, j in zip(tdatasets.get_tenrec(str(empty), num_rows=40),
                    jdatasets.get_tenrec(str(empty), num_rows=40)):
        assert_same_data(t, j, "tenrec, empty path")


# ---- examples/09 ------------------------------------------------------------

def _bce_softplus(labels, logits, sample_weight=None):
    labels = labels.reshape(logits.shape).astype(logits.dtype)
    return jlosses._weighted_mean(jax.nn.softplus(logits) - logits * labels, sample_weight)


def example09(pkg, wf, n=2000):
    rng = np.random.default_rng(0)
    raw = pkg.Dataset(
        {"userId": rng.integers(1000, 2000, n), "movieId": rng.choice([7, 11, 42, 99, 123], n),
         "rating": rng.integers(1, 6, n).astype(np.float64),
         "age": rng.integers(10, 80, n).astype(np.float32)},
        schema=pkg.Schema([pkg.ColumnSchema("userId", dtype="int64"),
                           pkg.ColumnSchema("movieId", dtype="int64"),
                           pkg.create_continuous_column("rating"),
                           pkg.create_continuous_column("age")]))
    train, valid = raw.split([0.8, 0.2], seed=1)
    w = wf.Workflow([
        wf.Categorify(["userId", "movieId"]),
        wf.TargetEncoding("movieId", target="rating", kfold=5, p_smooth=20,
                          out="TE_movieId_rating", tags=pkg.Tags.ITEM),
        wf.GroupbyCount("userId", log=True, tags=pkg.Tags.USER),
        wf.Bucketize({"age": [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]}, tags=pkg.Tags.USER),
        wf.LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                    tags=(pkg.Tags.BINARY_CLASSIFICATION, pkg.Tags.TARGET), dtype="int32"),
    ])
    return w.fit_transform(train), w.transform(valid)


def test_example_09_flow_matches_jax(monkeypatch):
    """The workflow of examples/09 into a DLRM fit and evaluate, on both
    packages (the JAX weights carried into the port)."""
    monkeypatch.setitem(jlosses.loss_registry._store, "binary_crossentropy", _bce_softplus)
    jtrain, jvalid = example09(mm, jwf)
    ttrain, tvalid = example09(mt, twf)
    assert_same_data(ttrain, jtrain, "train")
    assert_same_data(tvalid, jvalid, "valid")
    jm = mm.models.DLRMModel(jtrain.schema.excluding_by_name("rating"), embedding_dim=16,
                             top_block=(32, 16))
    tm = mt.DLRMModel(ttrain.schema.excluding_by_name("rating"), embedding_dim=16,
                      top_block=(32, 16), device="cpu")
    jm.build(mm.Loader(jtrain, 256))
    tm.build(ttrain, device="cpu")
    mt.load_jax_params(tm, {"/".join(str(p) for p in path): np.asarray(v[...])
                            for path, v in nnx.state(jm, nnx.Param).flat_state()})
    for m in (jm, tm):
        m.compile(learning_rate=0.01)
    jh = jm.fit(jtrain, epochs=1, batch_size=256, shuffle=False, verbose=0,
                validation_data=jvalid)
    th = tm.fit(ttrain, epochs=1, batch_size=256, shuffle=False, device="cpu",
                validation_data=tvalid)
    for k in ("loss", "val_loss", "val_rating_binary/auc"):
        np.testing.assert_allclose(th.history[k], jh.history[k], rtol=RTOL, err_msg=k)
    je, te = jm.evaluate(jvalid, batch_size=256), tm.evaluate(tvalid, batch_size=256,
                                                               device="cpu")
    for k in ("loss", "rating_binary/auc", "rating_binary/binary_accuracy"):
        np.testing.assert_allclose(te[k], je[k], rtol=RTOL, err_msg=k)
