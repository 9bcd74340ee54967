"""The port's getters on raw and prepared files, its ``schema.pbtxt`` reader
and ``PopularityLogitsCorrection.from_parquet``, against the JAX package's on
the CPU.

The raw layouts are the fabricated files of ``tests/unit/test_data.py``
(Criteo ``day_*`` plain and gzipped, Ali-CCP's skeleton and common features,
Booking.com's ``train_set.csv``, Tenrec's ``QK-video.csv``, the
transactions' ``transactions_train.csv``) plus Dressipi's three files; the
JAX package reads them with pandas, the port with ``csv`` and numpy. Train
and valid must be equal column by column (values and dtypes, as
``test_torch_data_plane.py`` holds them) with equal schemas. A prepared
parquet ``path`` (``train/`` and ``valid/``, or files split 80/20) reads the
same in both. Sizes: 20-300 raw rows.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pytest

import models_tpu as mm
from models_tpu.data import datasets as jdatasets
from models_tpu.transforms.bias import PopularityLogitsCorrection as JCorrection

import models_tpu_torch as mt
from models_tpu_torch.data import datasets as tdatasets
from models_tpu_torch.transforms.bias import PopularityLogitsCorrection as TCorrection



def assert_same_data(tds, jds, what=""):
    """Columns (values and dtypes; a list column's values of one kind, since
    the JAX package's arrow lists widen them to 64 bits) and schemas equal."""
    want, got = jds.to_numpy_dict(), tds.to_numpy_dict()
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        v = np.asarray(v)
        if k.endswith("__values"):
            assert got[k].dtype.kind == v.dtype.kind, (what, k, got[k].dtype, v.dtype)
        else:
            assert got[k].dtype == v.dtype, (what, k, got[k].dtype, v.dtype)
        np.testing.assert_array_equal(got[k], v, err_msg=f"{what}: {k}")
    assert tds.schema.to_dict() == jds.schema.to_dict(), what
    assert tds.column_names == list(jds.column_names), what


def assert_same_pair(got, want, what):
    got, want = list(got), list(want)
    assert len(got) == len(want) == 2, what
    for part, t, j in zip(("train", "valid"), got, want):
        assert t.num_rows == j.num_rows, (what, part)
        assert_same_data(t, j, f"{what} {part}")


def criteo(path):
    rng = np.random.default_rng(0)
    lines = []
    for _ in range(50):
        label = str(rng.integers(0, 2))
        ints = [str(rng.integers(0, 100)) if rng.random() > 0.2 else "" for _ in range(13)]
        cats = [format(rng.integers(0, 2**32), "x") if rng.random() > 0.1 else ""
                for _ in range(26)]
        lines.append("\t".join([label] + ints + cats))
    lines.append("1\t2\t3")  # a short line both skip
    (path / "day_0").write_text("\n".join(lines[:30]) + "\n")
    with gzip.open(path / "day_1.gz", "wt") as f:
        f.write("\n".join(lines[30:]) + "\n")


def aliccp(path):
    sep = "\x01"
    for data_type, n in (("train", 24), ("test", 12)):
        d = path / data_type
        d.mkdir()
        common = [f"c{ci},3," + sep.join([f"101:{ci + 1}:1", f"125:{ci + 2}:1",
                                           f"129:{ci + 5}:1"]) for ci in range(2)]
        (d / f"common_features_{data_type}.csv").write_text("\n".join(common) + "\n")
        rows, rng = [], np.random.default_rng(1)
        for i in range(n):
            click = int(rng.integers(0, 2))
            conv = int(rng.integers(0, 2)) if click else 0
            kv = sep.join([f"205:{int(rng.integers(1, 50))}:1", f"206:{int(rng.integers(1, 10))}:1",
                           f"301:{int(rng.integers(1, 4))}:1"])
            rows.append(f"s{i},{click},{conv},c{i % 2},3,{kv}")
        rows.append("sbad,0,1,c0,3,205:3:1")  # click 0 / conversion 1: dropped
        (d / f"sample_skeleton_{data_type}.csv").write_text("\n".join(rows) + "\n")


def booking(path):
    rng = np.random.default_rng(0)
    rows, base = [], pd.Timestamp("2016-01-01")
    for t in range(40):
        user = int(rng.integers(1, 12))
        start = base + pd.Timedelta(days=int(rng.integers(0, 200)))
        for i in range(int(rng.integers(2, 7))):
            ci = start + pd.Timedelta(days=3 * i)
            co = ci + pd.Timedelta(days=int(rng.integers(1, 4)))
            rows.append(dict(user_id=user, checkin=ci.date(), checkout=co.date(),
                             city_id=int(rng.integers(1, 50)),
                             device_class=["desktop", "mobile"][int(rng.integers(2))],
                             affiliate_id=int(rng.integers(0, 9)),
                             booker_country=["A", "B", "C"][int(rng.integers(3))],
                             hotel_country=["X", "Y"][int(rng.integers(2))],
                             utrip_id=f"{user}_{t}"))
    rows[5]["city_id"] = None  # a booking with no city: dropped
    pd.DataFrame(rows).to_csv(path / "train_set.csv", index=False)


def tenrec(path):
    rng = np.random.default_rng(4)
    n = 200
    pd.DataFrame({
        "user_id": rng.integers(1000, 1040, n), "item_id": rng.integers(5000, 5100, n),
        "click": rng.integers(0, 2, n), "follow": rng.integers(0, 2, n),
        "like": rng.integers(0, 2, n), "share": rng.integers(0, 2, n),
        "video_category": rng.integers(0, 4, n), "watching_times": rng.integers(0, 12, n),
        "gender": rng.integers(0, 3, n), "age": rng.integers(0, 8, n),
    }).to_csv(path / "QK-video.csv", index=False)


def transactions(path):
    rng = np.random.default_rng(5)
    n = 300
    pd.DataFrame({
        "t_dat": pd.to_datetime("2020-01-01") + pd.to_timedelta(rng.integers(0, 100, n),
                                                               unit="D"),
        "customer_id": [f"c{int(i):03d}" for i in rng.integers(0, 50, n)],
        "article_id": rng.integers(100000, 100200, n),
        "price": rng.uniform(0.01, 0.5, n),
        "sales_channel_id": rng.integers(1, 3, n),
    }).to_csv(path / "transactions_train.csv", index=False)


def dressipi(path):
    """Items with features in kept, dropped and widely covered categories
    (one item without features); sessions over 70 days, each with one
    purchase but one."""
    rng = np.random.default_rng(6)
    feats = []
    for item in range(1, 31):
        for cat in (3, 5, 17, 4, 28, 7, 99):
            if cat == 99 or rng.random() < 0.6:  # 99 covers every item: kept
                feats.append((item, cat, int(rng.integers(1, 900))))
    pd.DataFrame(feats, columns=["item_id", "feature_category_id", "feature_value_id"]
                 ).to_csv(path / "item_features.csv", index=False)
    t0 = pd.Timestamp("2021-01-01")
    sessions, purchases = [], []
    for s in range(1, 41):
        day = int(rng.integers(0, 70))
        for k in range(int(rng.integers(1, 5))):
            when = t0 + pd.Timedelta(days=day, seconds=int(rng.integers(0, 80000)),
                                     milliseconds=int(rng.integers(0, 1000)))
            sessions.append((s, int(rng.integers(1, 32)), when.strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]))
        if s != 7:
            when = t0 + pd.Timedelta(days=day, seconds=86000)
            purchases.append((s, int(rng.integers(1, 31)), when.strftime("%Y-%m-%d %H:%M:%S.%f")[:-3]))
    pd.DataFrame(sessions, columns=["session_id", "item_id", "date"]).to_csv(
        path / "train_sessions.csv", index=False)
    pd.DataFrame(purchases, columns=["session_id", "item_id", "date"]).to_csv(
        path / "train_purchases.csv", index=False)


RAW = {
    "criteo": (criteo, "get_criteo", dict(num_buckets=1000)),
    "aliccp": (aliccp, "get_aliccp", {}),
    "booking": (booking, "get_booking", {}),
    "tenrec": (tenrec, "get_tenrec", {}),
    "transactions": (transactions, "get_ecommerce_transactions", {}),
    "dressipi": (dressipi, "get_dressipi2022", {}),
}


@pytest.mark.parametrize("layout", sorted(RAW))
def test_raw_layouts_match_jax(tmp_path, layout):
    make, getter, kw = RAW[layout]
    make(tmp_path)
    got = getattr(tdatasets, getter)(str(tmp_path), **kw)
    want = getattr(jdatasets, getter)(str(tmp_path), **kw)
    assert_same_pair(got, want, layout)


def test_raw_dressipi_holds_floats_where_pandas_does(tmp_path):
    """An item with no features and a session with no purchase make their
    columns float, -1 where missing, as pandas' merge and fillna do."""
    dressipi(tmp_path)
    train, valid = tdatasets.get_dressipi2022(str(tmp_path))
    cols = {**train.to_numpy_dict()}
    assert cols["f_3"].dtype == np.float64 and (cols["f_3"] == -1).any()
    assert {c for c in train.column_names if c.startswith("f_")} == {
        "f_3", "f_5", "f_17", "f_99"}  # kept, covered; 4 and 28 dropped; 7 neither


@pytest.mark.parametrize("getter,kw", [("get_sigir", {}), ("get_criteo", {}),
                                       ("get_tenrec", {}), ("get_movielens", {})])
def test_prepared_parquet_paths_match_jax(tmp_path, getter, kw):
    """``train/`` and ``valid/`` directories, and a directory of parquet
    files split 80/20, written by the JAX package."""
    jtrain, jvalid = getattr(jdatasets, getter)(None, num_rows=60, **kw)
    jtrain.to_parquet(str(tmp_path / "tv" / "train"), num_partitions=2)
    jvalid.to_parquet(str(tmp_path / "tv" / "valid"))
    for where in ("tv", "tv/train"):
        got = getattr(tdatasets, getter)(str(tmp_path / where), num_rows=10, **kw)
        want = getattr(jdatasets, getter)(str(tmp_path / where), num_rows=10, **kw)
        if where == "tv":
            assert got[0].files is not None and len(got[0].files) == 2
        assert_same_pair(got, want, f"{getter} {where}")


def test_an_empty_path_synthesizes(tmp_path):
    for t, j in zip(tdatasets.get_tenrec(str(tmp_path), num_rows=40),
                    jdatasets.get_tenrec(str(tmp_path), num_rows=40)):
        assert_same_data(t, j, "tenrec, empty path")


PBTXT = '''
feature {
  name: "item_id"
  type: INT
  int_domain {
    name: "item_id"
    min: 0
    max: 999
    is_categorical: true
  }
  annotation {
    tag: "item_id"
    tag: "item"
    tag: "categorical"
  }
}
feature {
  name: "item_history"
  value_count {
    min: 1
    max: 20
  }
  type: INT
  int_domain {
    name: "item_id"
    min: 0
    max: 999
    is_categorical: true
  }
  annotation {
    tag: "item"
    tag: "list"
  }
}
feature {
  name: "click"
  type: INT
  annotation {
    tag: "binary_classification"
    tag: "target"
  }
}
feature {
  name: "price"
  type: FLOAT
  annotation {
    tag: "continuous"
  }
}
'''


def test_schema_from_pbtxt_matches_jax(tmp_path):
    got, want = mt.Schema.from_pbtxt(PBTXT), mm.Schema.from_pbtxt(PBTXT)
    assert got.to_dict() == want.to_dict()
    assert got["item_history"].is_list and got["click"].is_target
    # a dataset directory with only the pbtxt sidecar takes its schema
    ds = mm.data.generate_data("e-commerce", num_rows=20, seed=0).select_columns(["item_id",
                                                                                 "click"])
    path = ds.to_parquet(str(tmp_path / "p"))
    os.remove(os.path.join(path, "schema.json"))
    (tmp_path / "p" / "schema.pbtxt").write_text(PBTXT)
    assert mt.Dataset(path).schema.to_dict() == mm.data.Dataset(path).schema.to_dict() == \
        want.to_dict()
    os.remove(os.path.join(path, "schema.pbtxt"))  # no sidecar: inferred from the file
    assert mt.Dataset(path).schema.to_dict() == mm.data.Dataset(path).schema.to_dict()


def test_popularity_correction_from_parquet_matches_jax(tmp_path):
    """The frequencies read bit for bit; the log-probabilities within two
    float32 ulps (torch's and XLA's ``log`` round differently in the last
    bit, ROADMAP.md's known differences)."""
    freqs = np.random.default_rng(2).integers(0, 1000, 64).astype(np.int64)
    path = str(tmp_path / "f.parquet")
    mt.Dataset({"frequency": freqs, "item": np.arange(64)}).to_parquet(str(tmp_path / "d"))
    os.replace(str(tmp_path / "d" / "part_0.parquet"), path)
    got = TCorrection.from_parquet(path, reg_factor=0.5)
    want = JCorrection.from_parquet(path, reg_factor=0.5)
    probs = freqs.astype(np.float32) / np.float32(freqs.sum())
    np.testing.assert_array_equal(mt.data.parquet.read_table(path, ["frequency"])["frequency"],
                                  freqs)
    np.testing.assert_allclose(got.log_probs.numpy(), np.log(probs), rtol=2.5e-7)
    np.testing.assert_allclose(got.log_probs.numpy(), np.asarray(want.log_probs), rtol=2.5e-7)
    assert got.reg_factor == want.reg_factor == 0.5
