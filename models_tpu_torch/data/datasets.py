"""Named dataset getters (``models_tpu/data/datasets.py``): each returns a
(train, valid) pair of :class:`~models_tpu_torch.data.dataset.Dataset`.

Without ``path`` every getter synthesizes from its stored schema
(``generate_data(name, num_rows, set_sizes=(0.8, 0.2), seed=42)``), as the
JAX package does; nothing is downloaded. ``get_movielens(path)`` reads the
raw MovieLens layouts (ml-100k ``u.user`` / ``u.item`` / ``ua.base`` /
``ua.test`` or ``u.data``, ml-1m ``users.dat`` / ``movies.dat`` /
``ratings.dat``, ml-25m ``movies.csv`` / ``ratings.csv``) and runs the same
preparation and workflow as the JAX package, whose pandas reads, merges and
shuffle are written out here with the standard library's ``csv`` and numpy:

- a column's type is pandas' inference: int64 where every value reads as an
  integer, float64 where every value reads as a number (an empty field is
  NaN), else strings;
- ``merge(how="left")`` keeps the left rows in order, NaN where a key has
  no match;
- ``sample(frac=1.0, random_state=42)`` is ``RandomState(42).permutation``.

A list column (the genres) is held as the port's list column (an object
array of per-row int32 arrays), where the JAX package builds an arrow list.

The routes the port does not take raise ``NotImplementedError`` (ROADMAP.md
queue 1, item 6): a ``path`` of prepared parquet (the card's host has no
``pyarrow``) and the raw layouts of the other getters (Criteo ``day_*``,
Ali-CCP, Booking, Dressipi, Tenrec, the transactions). A ``path`` that holds
none of these synthesizes, as the JAX package does.
"""

from __future__ import annotations

import csv
import glob
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema import ColumnSchema, Schema, Tags, create_categorical_column
from ..schema import create_continuous_column
from .dataset import Dataset
from .synthetic import generate_data

Pair = Tuple[Dataset, Dataset]
_QUEUE = "ROADMAP.md queue 1, item 6"


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported ({_QUEUE}); without a path the getter "
                              "synthesizes from the stored schema")


def _has_parquet(path) -> bool:
    if path is None:
        return False
    train_p, valid_p = os.path.join(path, "train"), os.path.join(path, "valid")
    if os.path.isdir(train_p) and os.path.isdir(valid_p):
        return True
    return os.path.isdir(path) and any(f.endswith(".parquet") for f in os.listdir(path))


def _from_path_or_synthetic(path, name: str, num_rows: int, seed: int = 42) -> Pair:
    if _has_parquet(path):
        _not_ported(f"reading prepared parquet ({path})")
    train, valid = generate_data(name, num_rows=num_rows, set_sizes=(0.8, 0.2), seed=seed)
    return train, valid


# ---------------------------------------------------------------------------
# delimited files as pandas reads them
# ---------------------------------------------------------------------------

def _infer(values: Sequence[str]) -> np.ndarray:
    """One column's fields as pandas' ``read_csv`` types them: int64, else
    float64 (an empty field NaN), else strings (an empty field NaN)."""
    try:
        return np.asarray([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(v) if v != "" else np.nan for v in values], dtype=np.float64)
    except ValueError:
        pass
    out = np.empty(len(values), dtype=object)
    out[:] = [v if v != "" else np.nan for v in values]
    return out


def _frame(rows: List[List[str]], names: Sequence[str]) -> Dict[str, np.ndarray]:
    width = len(names)
    cols = list(zip(*[(r + [""] * width)[:width] for r in rows])) if rows else [()] * width
    return {name: _infer(list(col)) for name, col in zip(names, cols)}


def _read_sep(path: str, sep: str, names: Sequence[str], encoding: str = "utf-8"):
    """A headerless file whose fields are split by the string ``sep``."""
    with open(path, encoding=encoding, newline="") as fh:
        rows = [line.rstrip("\r\n").split(sep) for line in fh if line.rstrip("\r\n")]
    return _frame(rows, names)


def _read_csv(path: str) -> Dict[str, np.ndarray]:
    """A comma-separated file with a header row (quoted fields as pandas
    reads them)."""
    with open(path, encoding="utf-8", newline="") as fh:
        rows = list(csv.reader(fh))
    return _frame([r for r in rows[1:] if r], rows[0])


def _rows(frame: Dict[str, np.ndarray]) -> int:
    return len(next(iter(frame.values())))


def _take(frame: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in frame.items()}


def _merge_left(left: Dict[str, np.ndarray], right: Dict[str, np.ndarray], on: str
                ) -> Dict[str, np.ndarray]:
    """``left.merge(right, on=on, how="left")`` for a right side whose keys
    are unique: the left rows in their order, the right's other columns
    beside them, NaN where a key has no match (an int column then float)."""
    pos = {k: i for i, k in enumerate(right[on].tolist())}
    where = np.asarray([pos.get(k, -1) for k in left[on].tolist()], dtype=np.int64)
    hit = where >= 0
    out = dict(left)
    for name, col in right.items():
        if name == on:
            continue
        if hit.all():
            out[name] = col[where]
        elif col.dtype == object:
            vals = np.empty(len(where), dtype=object)
            vals[:] = np.nan
            vals[hit] = col[where[hit]]
            out[name] = vals
        else:
            vals = np.full(len(where), np.nan)
            vals[hit] = col[where[hit]]
            out[name] = vals
    return out


def _shuffled_split(frame: Dict[str, np.ndarray]):
    """``frame.sample(frac=1.0, random_state=42)``, then its last 20% of
    rows the validation split."""
    n = _rows(frame)
    frame = _take(frame, np.random.RandomState(42).permutation(n))
    n_valid = int(n * 0.2)
    return _take(frame, slice(None, n - n_valid)), _take(frame, slice(n - n_valid, None))


# ---------------------------------------------------------------------------
# MovieLens
# ---------------------------------------------------------------------------

def get_movielens(path: Optional[str] = None, variant: str = "ml-100k",
                  num_rows: int = 100_000) -> Pair:
    """MovieLens 100k, 1M or 25M (``variant``): the raw layout under
    ``path`` prepared as the JAX package prepares it, else synthesized."""
    name = {"ml-100k": "movielens-100k", "ml-1m": "movielens-1m",
            "ml-25m": "movielens-25m"}.get(variant, variant)
    if path is not None:
        raw = _load_movielens_raw(path, variant)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, name, num_rows)


def movielens_100k_workflow():
    """The ml-100k workflow: Categorify the ids, genres and demographics,
    target-encode movieId against the rating (kfold 5, p_smooth 20,
    normalized), log-count userId, bucketize age by decade, and the
    ``rating`` / ``rating_binary`` targets."""
    from .workflow import Bucketize, Categorify, GroupbyCount, LambdaOp, TargetEncoding, Workflow

    return Workflow([
        Categorify(["movieId", "userId", "genres", "gender", "zip_code"]),
        TargetEncoding("movieId", target="rating", kfold=5, p_smooth=20.0,
                       out="TE_movieId_rating", normalize=True, tags=Tags.ITEM),
        GroupbyCount("userId", log=True, out="userId_count", tags=Tags.USER),
        Bucketize({"age": [0, 10, 20, 30, 40, 50, 60, 70, 80, 90]}, tags=Tags.USER),
        LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                 tags=("binary_classification", "target"), dtype="int32"),
        LambdaOp("rating", lambda v: v.astype("float32"),
                 tags=("regression", "target"), dtype="float32"),
    ])


def movielens_1m_workflow():
    """The ml-1m workflow: Categorify the ids and demographics, target-encode
    movieId, userId, age, gender, occupation and zipcode against the rating,
    and the targets; the genres list is made outside it."""
    from .workflow import Categorify, LambdaOp, TargetEncoding, Workflow

    te = dict(target="rating", kfold=5, p_smooth=20.0, normalize=True)
    return Workflow([
        Categorify(["movieId", "userId", "gender", "age", "occupation", "zipcode"]),
        TargetEncoding("movieId", out="TE_movieId_rating", tags=Tags.ITEM, **te),
        TargetEncoding("userId", out="TE_userId_rating", tags=Tags.USER, **te),
        TargetEncoding("age", out="TE_age_rating", tags=Tags.USER, **te),
        TargetEncoding("gender", out="TE_gender_rating", tags=Tags.USER, **te),
        TargetEncoding("occupation", out="TE_occupation_rating", tags=Tags.USER, **te),
        TargetEncoding("zipcode", out="TE_zipcode_rating", tags=Tags.USER, **te),
        LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                 tags=("binary_classification", "target"), dtype="int32"),
        LambdaOp("rating", lambda v: v.astype("float32"),
                 tags=("regression", "target"), dtype="float32"),
    ])


def movielens_25m_workflow():
    """The ml-25m workflow: Categorify the ids, the normalized
    TE_movieId_rating, the log count of userId, and the targets; the genres
    list is made outside it."""
    from .workflow import Categorify, GroupbyCount, LambdaOp, TargetEncoding, Workflow

    return Workflow([
        Categorify(["movieId", "userId"]),
        TargetEncoding("movieId", target="rating", kfold=5, p_smooth=20.0,
                       out="TE_movieId_rating", normalize=True, tags=Tags.ITEM),
        GroupbyCount("userId", log=True, out="userId_count", tags=Tags.USER),
        LambdaOp("rating", lambda v: (v > 3).astype("int32"), out="rating_binary",
                 tags=("binary_classification", "target"), dtype="int32"),
        LambdaOp("rating", lambda v: v.astype("float32"),
                 tags=("regression", "target"), dtype="float32"),
    ])


_ML100K_GENRES = [
    "unknown", "Action", "Adventure", "Animation", "Childrens", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film_Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]


def _retag(ds: Dataset, tags: Dict[str, tuple]) -> List[ColumnSchema]:
    return [c.with_tags(tags[c.name]) if c.name in tags else c for c in ds.schema]


def _load_movielens_100k_full(path: str) -> Optional[Pair]:
    """The ml-100k layout: ratings joined with the users' demographics and
    the movies' titles and genre strings, then
    :func:`movielens_100k_workflow`."""
    u_user, u_item = os.path.join(path, "u.user"), os.path.join(path, "u.item")
    ua_base, ua_test = os.path.join(path, "ua.base"), os.path.join(path, "ua.test")
    if not (os.path.exists(u_user) and os.path.exists(u_item)):
        return None
    users = _read_sep(u_user, "|", ["userId", "age", "gender", "occupation", "zip_code"])
    movies = _read_sep(u_item, "|", ["movieId", "title", "release_date", "video_release_date",
                                     "imdb_URL"] + _ML100K_GENRES, encoding="latin1")
    flags = np.stack([movies[g].astype(bool) for g in _ML100K_GENRES], axis=1)
    genres = np.empty(len(flags), dtype=object)
    genres[:] = [",".join(g for g, on in zip(_ML100K_GENRES, row) if on) for row in flags]
    movies = {"movieId": movies["movieId"], "title": movies["title"], "genres": genres}
    names = ["userId", "movieId", "rating", "timestamp"]
    if os.path.exists(ua_base) and os.path.exists(ua_test):
        train_df, valid_df = _read_sep(ua_base, "\t", names), _read_sep(ua_test, "\t", names)
    else:
        train_df, valid_df = _shuffled_split(_read_sep(os.path.join(path, "u.data"), "\t",
                                                       names))

    def prep(df):
        df = _merge_left(_merge_left(df, users, "userId"), movies, "movieId")
        data = {c: df[c] for c in ["userId", "movieId", "rating", "age", "gender", "zip_code",
                                   "genres", "title"]}
        cols = [
            ColumnSchema("userId", dtype="int64"),
            ColumnSchema("movieId", dtype="int64"),
            create_continuous_column("rating"),
            create_continuous_column("age"),
            ColumnSchema("gender", dtype="bytes"),
            ColumnSchema("zip_code", dtype="bytes"),
            ColumnSchema("genres", dtype="bytes"),
            ColumnSchema("title", dtype="bytes"),
        ]
        return Dataset(data, schema=Schema(cols))

    wf = movielens_100k_workflow()
    train, valid = wf.fit_transform(prep(train_df)), wf.transform(prep(valid_df))
    tags = {"movieId": (Tags.ITEM, Tags.ITEM_ID), "userId": (Tags.USER, Tags.USER_ID),
            "genres": (Tags.ITEM,)}
    return tuple(Dataset(ds.columns(), schema=Schema(_retag(ds, tags)))
                 for ds in (train, valid))


def _encode_genres_list(genre_strs, vocab=None):
    """``"A|B|C"`` strings -> (lists of int ids, vocab): ids by falling
    frequency over the first call's rows (ties in first-seen order), 0 the
    unknown or empty."""
    lists = [s.split("|") if isinstance(s, str) and s else [] for s in genre_strs]
    if vocab is None:
        counts = Counter(g for row in lists for g in row)
        vocab = {g: i + 1 for i, (g, _) in enumerate(counts.most_common())}
    return [[vocab.get(g, 0) for g in row] for row in lists], vocab


def _movielens_join_and_transform(train_df, valid_df, workflow, genre_col=None,
                                  genre_vocab_size=None, max_genres=8) -> Pair:
    """The shared tail of the ml-1m and ml-25m preparations: the workflow on
    the joined frames, the id columns re-tagged, the genres list column."""

    def to_ds(df):
        scalar = [c for c in df if c != "genres"]
        cols = []
        for c in scalar:
            kind = df[c].dtype.kind
            cols.append(create_continuous_column(c) if kind == "f" else
                        ColumnSchema(c, dtype="int64") if kind in "iu" else
                        ColumnSchema(c, dtype="bytes"))
        return Dataset({c: df[c] for c in scalar}, schema=Schema(cols))

    wf_train = workflow.fit_transform(to_ds(train_df))
    wf_valid = workflow.transform(to_ds(valid_df))
    tags = {"movieId": (Tags.ITEM, Tags.ITEM_ID), "userId": (Tags.USER, Tags.USER_ID),
            **{c: (Tags.USER,) for c in ("age", "gender", "occupation", "zipcode")}}
    genre_vocab = None

    def finalize(ds, df):
        nonlocal genre_vocab
        data = ds.columns()
        cols = _retag(ds, tags)
        if genre_col is not None:
            ids, genre_vocab = _encode_genres_list(df[genre_col].tolist(), genre_vocab)
            rows = np.empty(len(ids), dtype=object)
            rows[:] = [np.asarray(row[:max_genres], dtype=np.int32) for row in ids]
            data["genres"] = rows
            cols.append(create_categorical_column(
                "genres", genre_vocab_size or (max(genre_vocab.values()) if genre_vocab else 1),
                tags=(Tags.ITEM,), is_list=True, max_seq_length=max_genres))
        return Dataset({c.name: data[c.name] for c in cols}, schema=Schema(cols))

    return finalize(wf_train, train_df), finalize(wf_valid, valid_df)


def _load_movielens_1m_full(path: str) -> Optional[Pair]:
    """The ml-1m layout (``::``-separated): ratings joined with the users and
    the movies' genres, an 80/20 shuffled split, :func:`movielens_1m_workflow`."""
    paths = {n: os.path.join(path, n) for n in ("users.dat", "movies.dat", "ratings.dat")}
    if not all(os.path.exists(p) for p in paths.values()):
        return None
    users = _read_sep(paths["users.dat"], "::",
                      ["userId", "gender", "age", "occupation", "zipcode"], "latin1")
    movies = _read_sep(paths["movies.dat"], "::", ["movieId", "title", "genres"], "latin1")
    ratings = _read_sep(paths["ratings.dat"], "::",
                        ["userId", "movieId", "rating", "timestamp"], "latin1")
    joined = _merge_left(_merge_left(ratings, users, "userId"),
                         {"movieId": movies["movieId"], "genres": movies["genres"]}, "movieId")
    train_df, valid_df = _shuffled_split(joined)
    return _movielens_join_and_transform(train_df, valid_df, movielens_1m_workflow(),
                                         genre_col="genres")


def _load_movielens_25m_full(path: str) -> Optional[Pair]:
    """The ml-25m layout (``movies.csv`` and ``ratings.csv``): the genres
    joined, an 80/20 shuffled split, :func:`movielens_25m_workflow`."""
    movies_csv, ratings_csv = os.path.join(path, "movies.csv"), os.path.join(path, "ratings.csv")
    if not (os.path.exists(movies_csv) and os.path.exists(ratings_csv)):
        return None
    movies, ratings = _read_csv(movies_csv), _read_csv(ratings_csv)
    joined = _merge_left(ratings, {"movieId": movies["movieId"], "genres": movies["genres"]},
                         "movieId")
    train_df, valid_df = _shuffled_split(joined)
    return _movielens_join_and_transform(train_df, valid_df, movielens_25m_workflow(),
                                         genre_col="genres")


def _load_movielens_raw(path: str, variant: str) -> Optional[Pair]:
    """The full layout of ``variant`` where present; else the ratings alone
    (``u.data``, ``ratings.dat`` or ``ratings.csv``), split 80/20."""
    loaders = {"ml-100k": _load_movielens_100k_full, "movielens-100k": _load_movielens_100k_full,
               "ml-1m": _load_movielens_1m_full, "movielens-1m": _load_movielens_1m_full,
               "ml-25m": _load_movielens_25m_full, "movielens-25m": _load_movielens_25m_full}
    if variant in loaders:
        full = loaders[variant](path)
        if full is not None:
            return full
    udata = os.path.join(path, "u.data")
    ratings_dat = os.path.join(path, "ratings.dat")
    ratings_csv = os.path.join(path, "ratings.csv")
    if os.path.exists(udata):
        arr = np.loadtxt(udata, dtype=np.int64)
        users, items, ratings = arr[:, 0], arr[:, 1], arr[:, 2]
    elif os.path.exists(ratings_dat):
        rows = []
        with open(ratings_dat) as fh:
            for line in fh:
                parts = line.strip().split("::")
                if len(parts) >= 3:
                    rows.append((int(parts[0]), int(parts[1]), float(parts[2])))
        if not rows:
            return None
        arr = np.asarray(rows)
        users, items, ratings = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]
    elif os.path.exists(ratings_csv):
        arr = np.genfromtxt(ratings_csv, delimiter=",", skip_header=1)
        users, items, ratings = arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64), arr[:, 2]
    else:
        return None
    schema = Schema([
        create_categorical_column("userId", int(users.max()), tags=(Tags.USER, Tags.USER_ID)),
        create_categorical_column("movieId", int(items.max()), tags=(Tags.ITEM, Tags.ITEM_ID)),
        ColumnSchema("rating", tags=(Tags.REGRESSION, Tags.TARGET), dtype="float32"),
        ColumnSchema("rating_binary", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
                     dtype="int32"),
    ])
    data = {
        "userId": users.astype(np.int32),
        "movieId": items.astype(np.int32),
        "rating": ratings.astype(np.float32),
        "rating_binary": (ratings >= 4).astype(np.int32),
    }
    train, valid = Dataset(data, schema=schema).split([0.8, 0.2], seed=42)
    return train, valid


# ---------------------------------------------------------------------------
# the other getters: synthesized; their raw layouts are not ported
# ---------------------------------------------------------------------------

def _refuse_raw(path, files: Sequence[str], what: str) -> None:
    if path is not None and any(os.path.exists(os.path.join(path, f)) for f in files):
        _not_ported(f"the raw {what} layout under {path}")


def get_criteo(path: Optional[str] = None, num_rows: int = 100_000,
               num_buckets: int = 10_000_000, max_rows: Optional[int] = None) -> Pair:
    """Criteo 1TB click logs: synthesized from the ``criteo`` schema (the
    raw ``day_*`` files are not ported)."""
    if path is not None and (glob.glob(os.path.join(path, "day_*[0-9]"))
                             or glob.glob(os.path.join(path, "day_*.gz"))):
        _not_ported(f"the raw Criteo day_* files under {path}")
    return _from_path_or_synthetic(path, "criteo", num_rows)


def get_aliccp(path: Optional[str] = None, num_rows: int = 100_000,
               max_rows: Optional[int] = None) -> Pair:
    """Ali-CCP: synthesized from the ``aliccp`` schema (the raw release's
    sample skeleton and common features are not ported)."""
    _refuse_raw(path, [os.path.join("train", "sample_skeleton_train.csv")], "Ali-CCP")
    return _from_path_or_synthetic(path, "aliccp", num_rows)


def get_booking(path: Optional[str] = None, num_rows: int = 50_000) -> Pair:
    """Booking.com trips: synthesized from the ``booking`` schema (the raw
    ``train_set.csv`` is not ported)."""
    _refuse_raw(path, ["train_set.csv"], "Booking.com")
    return _from_path_or_synthetic(path, "booking", num_rows)


def get_dressipi2022(path: Optional[str] = None, num_rows: int = 50_000,
                     category_coverage_min: float = 0.8) -> Pair:
    """Dressipi RecSys'22 sessions: synthesized from the
    ``dressipi2022-preprocessed`` schema (the raw release is not ported)."""
    if path is not None and os.path.isdir(path):
        _refuse_raw(path, ["train_sessions.csv"], "Dressipi")
    return _from_path_or_synthetic(path, "dressipi2022-preprocessed", num_rows)


def get_sigir(path: Optional[str] = None, num_rows: int = 50_000,
              table: str = "browsing") -> Pair:
    """SIGIR'21 e-commerce challenge, ``table`` "browsing" or "sku":
    synthesized from its stored schema."""
    name = {"browsing": "sigir-browsing", "sku": "sigir-sku"}.get(table)
    if name is None:
        raise ValueError(f"table must be 'browsing' or 'sku', got {table!r}")
    return _from_path_or_synthetic(path, name, num_rows)


def get_tenrec(path: Optional[str] = None, num_rows: int = 50_000,
               table: str = "QK-video") -> Pair:
    """Tenrec multi-task feedback: synthesized from the ``tenrec-video``
    schema (the raw CSV is not ported)."""
    _refuse_raw(path, [f"{table}.csv"], "Tenrec")
    return _from_path_or_synthetic(path, "tenrec-video", num_rows)


def get_ecommerce_transactions(path: Optional[str] = None, num_rows: int = 50_000) -> Pair:
    """H&M-style purchase transactions: synthesized from the
    ``transactions`` schema (the raw ``transactions_train.csv`` is not
    ported)."""
    _refuse_raw(path, ["transactions_train.csv"], "transactions")
    return _from_path_or_synthetic(path, "transactions", num_rows)
