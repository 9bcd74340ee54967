"""Named dataset getters (``models_tpu/data/datasets.py``): each returns a
(train, valid) pair of :class:`~models_tpu_torch.data.dataset.Dataset`.

A ``path`` that holds prepared parquet (``train/`` and ``valid/``
directories, or parquet files split 80/20 with seed 42) is read with the
port's codec (``data/parquet.py``). A ``path`` that holds a getter's raw
layout is prepared as the JAX package prepares it: the MovieLens layouts
(ml-100k ``u.user`` / ``u.item`` / ``ua.base`` / ``ua.test`` or ``u.data``,
ml-1m ``users.dat`` / ``movies.dat`` / ``ratings.dat``, ml-25m ``movies.csv`` /
``ratings.csv``), Criteo's ``day_*`` files (``.gz`` too), Ali-CCP's
``{train,test}/sample_skeleton_*.csv`` and ``common_features_*.csv``,
Booking.com's ``train_set.csv``, Dressipi's ``train_sessions.csv``,
``train_purchases.csv`` and ``item_features.csv``, Tenrec's
``QK-video.csv`` and the transactions' ``transactions_train.csv``. Without
either, a getter synthesizes from its stored schema
(``generate_data(name, num_rows, set_sizes=(0.8, 0.2), seed=42)``), as the
JAX package does; nothing is downloaded.

The JAX package's pandas reads, merges, sorts and group-bys are written out
here with the standard library's ``csv`` and numpy:

- a column's type is pandas' inference: int64 where every value reads as an
  integer, float64 where every value reads as a number (an empty field is
  NaN), else strings; a date column parses to microseconds (pandas 3's
  resolution);
- ``merge(how="left")`` keeps the left rows in order, NaN where a key has
  no match;
- ``sample(frac=1.0, random_state=42)`` is ``RandomState(42).permutation``;
- ``value_counts()`` orders by falling count, ties in first-seen order;
- stable sorts are ``np.lexsort``; ``groupby(sort=False)`` keeps the groups
  in the order they first appear.

A list column (the genres, a trip's cities) is held as the port's list
column (an object array of per-row arrays), where the JAX package builds an
arrow list.
"""

from __future__ import annotations

import csv
import glob
import gzip
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schema import ColumnSchema, Domain, Schema, Tags, create_categorical_column
from ..schema import create_continuous_column
from .dataset import Dataset
from .synthetic import generate_data

Pair = Tuple[Dataset, Dataset]


def _from_path_or_synthetic(path, name: str, num_rows: int, seed: int = 42):
    if path is not None:
        train_p, valid_p = os.path.join(path, "train"), os.path.join(path, "valid")
        if os.path.isdir(train_p) and os.path.isdir(valid_p):
            return Dataset.from_parquet(train_p), Dataset.from_parquet(valid_p)
        if os.path.isdir(path) and any(f.endswith(".parquet") for f in os.listdir(path)):
            train, valid = Dataset.from_parquet(path).split([0.8, 0.2], seed=seed)
            return train, valid
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
    """``left.merge(right, on=on, how="left")``: each left row in order,
    repeated once a matching right row (in the right's order), the right's
    other columns beside it, NaN where a key has no match (an int column
    then float)."""
    matches: Dict[object, List[int]] = {}
    for j, k in enumerate(right[on].tolist()):
        matches.setdefault(k, []).append(j)
    li, ri = [], []
    for i, k in enumerate(left[on].tolist()):
        for j in matches.get(k, [-1]):
            li.append(i)
            ri.append(j)
    ri = np.asarray(ri, np.int64)
    out = _take(left, np.asarray(li, np.int64))
    hit = ri >= 0
    for name, col in right.items():
        if name == on:
            continue
        if hit.all():
            out[name] = col[ri]
            continue
        vals = np.empty(len(ri), dtype=object) if col.dtype == object else np.empty(len(ri))
        vals[:] = np.nan
        vals[hit] = col[ri[hit]]
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
# Criteo
# ---------------------------------------------------------------------------

def get_criteo(path: Optional[str] = None, num_rows: int = 100_000,
               num_buckets: int = 10_000_000, max_rows: Optional[int] = None):
    """Criteo 1TB click logs. With ``path`` holding raw ``day_*`` TSV files
    (``.gz`` too): the label, 13 integer features (missing 0, as float32)
    and 26 hex categoricals hashed into ``num_buckets``, at most ``max_rows
    or num_rows`` rows, split 80/20 (seed 42). Else prepared parquet or
    synthesized."""
    if path is not None:
        raw = _load_criteo_raw(path, num_buckets=num_buckets, max_rows=max_rows or num_rows)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, "criteo", num_rows)


def _load_criteo_raw(path: str, num_buckets: int, max_rows: Optional[int]):
    files = sorted(glob.glob(os.path.join(path, "day_*[0-9]"))
                   + glob.glob(os.path.join(path, "day_*.gz")))
    if not files:
        return None
    labels, ints, cats = [], [], []
    n = 0
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 40:
                    continue
                labels.append(int(parts[0]))
                ints.append([int(v) if v else 0 for v in parts[1:14]])
                cats.append([int(v, 16) % num_buckets if v else 0 for v in parts[14:40]])
                n += 1
                if max_rows and n >= max_rows:
                    break
        if max_rows and n >= max_rows:
            break
    if not n:
        return None
    cols = {"label": np.asarray(labels, np.int32)}
    schema_cols = [ColumnSchema("label", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
                                dtype="int32")]
    ints = np.asarray(ints, np.float32)
    cats = np.asarray(cats, np.int64)
    for i in range(13):
        cols[f"I{i + 1}"] = ints[:, i]
        schema_cols.append(ColumnSchema(f"I{i + 1}", tags=(Tags.CONTINUOUS,), dtype="float32"))
    for i in range(26):
        cols[f"C{i + 1}"] = cats[:, i]
        schema_cols.append(create_categorical_column(f"C{i + 1}", num_buckets - 1))
    return Dataset(cols, schema=Schema(schema_cols)).split([0.8, 0.2], seed=42)


# ---------------------------------------------------------------------------
# Ali-CCP
# ---------------------------------------------------------------------------

def get_aliccp(path: Optional[str] = None, num_rows: int = 100_000,
               max_rows: Optional[int] = None):
    """Ali-CCP CTR/CVR. With ``path`` holding the raw release layout
    (``{train,test}/sample_skeleton_{train,test}.csv`` and
    ``common_features_{train,test}.csv``, ``\\x01``-separated
    ``field:feat:value`` triplets), the reference's field ids mapped to
    feature names. Else prepared parquet or synthesized."""
    if path is not None:
        raw = _load_aliccp_raw(path, max_rows=max_rows)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, "aliccp", num_rows)


# field id -> column name (the scalar fields; a multi-valued field keeps its
# last value, as the reference's dict(zip) does)
_ALICCP_FIELDS = {
    "101": ("user_id", (Tags.USER, Tags.USER_ID)),
    "121": ("user_profile", (Tags.USER,)),
    "122": ("user_group", (Tags.USER,)),
    "124": ("user_gender", (Tags.USER,)),
    "125": ("user_age", (Tags.USER,)),
    "126": ("user_consumption_1", (Tags.USER,)),
    "127": ("user_consumption_2", (Tags.USER,)),
    "128": ("user_is_occupied", (Tags.USER,)),
    "129": ("user_geography", (Tags.USER,)),
    "205": ("item_id", (Tags.ITEM, Tags.ITEM_ID)),
    "206": ("item_category", (Tags.ITEM,)),
    "207": ("item_shop", (Tags.ITEM,)),
    "210": ("item_intention", (Tags.ITEM,)),
    "216": ("item_brand", (Tags.ITEM,)),
    "301": ("position", ()),
}


def _parse_aliccp_kv(field_str: str) -> Dict[str, str]:
    out = {}
    for triplet in field_str.split("\x01"):
        parts = triplet.split(":")
        if len(parts) >= 2:
            out[parts[0]] = parts[1]
    return out


def _load_aliccp_split(base: str, data_type: str, max_rows: Optional[int]):
    skel = os.path.join(base, data_type, f"sample_skeleton_{data_type}.csv")
    commf = os.path.join(base, data_type, f"common_features_{data_type}.csv")
    if not (os.path.exists(skel) and os.path.exists(commf)):
        return None
    rows, needed = [], set()
    with open(skel) as fh:
        for i, line in enumerate(fh):
            if max_rows and i >= max_rows:
                break
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            if parts[1] == "0" and parts[2] == "1":
                continue  # the reference drops click=0, conversion=1 rows
            feats = _parse_aliccp_kv(parts[5])
            feats["click"], feats["conversion"], feats["__common__"] = parts[1], parts[2], parts[3]
            needed.add(parts[3])
            rows.append(feats)
    common = {}  # only the common-feature lines the rows name are parsed
    with open(commf) as fh:
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) >= 3 and parts[0] in needed:
                common[parts[0]] = _parse_aliccp_kv(parts[2])
                if len(common) == len(needed):
                    break
    for feats in rows:  # common features override the skeleton's
        feats.update(common.get(feats.pop("__common__"), {}))
    return rows


def _load_aliccp_raw(path: str, max_rows: Optional[int]):
    train_rows = _load_aliccp_split(path, "train", max_rows)
    test_rows = _load_aliccp_split(path, "test", max_rows)
    if not train_rows:
        return None

    def build(rows, cards):
        cols = {"click": np.asarray([int(r["click"]) for r in rows], np.int32),
                "conversion": np.asarray([int(r["conversion"]) for r in rows], np.int32)}
        for fid, (name, _) in _ALICCP_FIELDS.items():
            vals = np.asarray([int(r.get(fid, 0)) for r in rows], np.int64)
            cols[name] = vals
            cards[name] = max(cards.get(name, 0), int(vals.max()))
        return cols

    cards: dict = {}
    train_cols = build(train_rows, cards)
    test_cols = build(test_rows, cards) if test_rows else None
    schema_cols = [
        ColumnSchema("click", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="int32"),
        ColumnSchema("conversion", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
                     dtype="int32"),
    ]
    for name, tags in _ALICCP_FIELDS.values():
        schema_cols.append(create_categorical_column(name, cards[name], tags=tags))
    schema = Schema(schema_cols)
    train = Dataset(train_cols, schema=schema)
    if test_cols is not None:
        return train, Dataset(test_cols, schema=schema)
    return train.split([0.8, 0.2], seed=42)


# ---------------------------------------------------------------------------
# pandas' idioms of the remaining preparations
# ---------------------------------------------------------------------------

def _isna(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _categorify_freq(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """``value_counts`` order (falling count, ties first-seen) as codes from
    1, 0 for a missing value: (codes, vocabulary size with the 0)."""
    vals = values.tolist()
    counts = Counter(v for v in vals if not _isna(v))
    mapping = {v: i + 1 for i, (v, _) in enumerate(counts.most_common())}
    codes = np.asarray([0 if _isna(v) else mapping[v] for v in vals], np.int64)
    return codes, len(mapping) + 1


def _dates(values: np.ndarray) -> np.ndarray:
    """A date column as pandas 3 parses it: datetime64[us] (NaT where
    empty)."""
    return np.asarray(["NaT" if _isna(v) else str(v) for v in values.tolist()],
                      dtype="datetime64[us]")


def _days(delta: np.ndarray) -> np.ndarray:
    """``Timedelta.days``: whole days, floored."""
    return np.floor_divide(delta.astype(np.int64), 86_400_000_000)


def _weekday(dt: np.ndarray) -> np.ndarray:
    return (_days(dt - np.datetime64("1970-01-01", "us")) + 3) % 7  # 1970-01-01 a Thursday


def _month(dt: np.ndarray) -> np.ndarray:
    return dt.astype("datetime64[M]").astype(np.int64) % 12 + 1


def _drop_missing(frame: Dict[str, np.ndarray], names: Sequence[str]) -> Dict[str, np.ndarray]:
    keep = np.ones(_rows(frame), bool)
    for name in names:
        col = frame[name]
        keep &= ~(np.isnat(col) if col.dtype.kind == "M" else
                  np.asarray([_isna(v) for v in col.tolist()], bool))
    return _take(frame, keep)


# ---------------------------------------------------------------------------
# Booking.com
# ---------------------------------------------------------------------------

def get_booking(path: Optional[str] = None, num_rows: int = 50_000) -> Pair:
    """Booking.com trips. With ``path`` holding the raw ``train_set.csv``,
    :func:`_load_booking_raw`; else prepared parquet or synthesized."""
    if path is not None:
        raw = _load_booking_raw(path)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, "booking", num_rows)


def _load_booking_raw(path: str, max_trip_len: int = 20) -> Optional[Pair]:
    """The reference's trip preparation: calendar features of each booking
    (checkin month and weekday, checkout weekday, weekend, season, stay
    length in days, the checkout weekday's sine and cosine), frequency
    Categorify (0 = missing) of the ids, bookings grouped by trip in
    checkout order (list columns of at most ``max_trip_len``; the first
    value of the trip-level ones), and an 80/20 split of the trips
    (RandomState(42))."""
    train_csv = os.path.join(path, "train_set.csv")
    if not os.path.exists(train_csv):
        return None
    df = _read_csv(train_csv)
    df["checkin"], df["checkout"] = _dates(df["checkin"]), _dates(df["checkout"])
    df = _drop_missing(df, ["utrip_id", "city_id", "checkin", "checkout"])
    df["timestamp"] = df["checkout"].astype(np.int64)
    df["month"] = _month(df["checkin"])
    df["weekday_checkin"] = _weekday(df["checkin"])
    df["weekday_checkout"] = _weekday(df["checkout"])
    df["is_weekend"] = np.isin(df["weekday_checkin"], [5, 6]).astype(np.int64)
    df["length"] = _days(df["checkout"] - df["checkin"]).astype(np.float32)
    scaled = (df["weekday_checkout"] + 1 + 1e-6) / 7.0
    df["dayofweek_sin"] = np.sin(2 * np.pi * scaled).astype(np.float32)
    df["dayofweek_cos"] = np.cos(2 * np.pi * scaled).astype(np.float32)

    vocab: Dict[str, int] = {}
    for c in ("city_id", "booker_country", "hotel_country", "device_class", "affiliate_id",
              "user_id", "utrip_id"):
        df[c], vocab[c] = _categorify_freq(df[c])
    vocab.update(month=13, weekday_checkin=7, weekday_checkout=7, is_weekend=2, season=4)

    df = _take(df, np.lexsort((df["timestamp"], df["utrip_id"])))
    trip_ids, starts = np.unique(df["utrip_id"], return_index=True)  # sorted: first-seen order
    ends = np.append(starts[1:], len(df["utrip_id"]))
    seq_cols = ["city_id", "booker_country", "hotel_country", "month", "weekday_checkin",
                "weekday_checkout", "is_weekend", "dayofweek_sin", "dayofweek_cos"]
    lists = {c: [df[c][a:min(b, a + max_trip_len)] for a, b in zip(starts, ends)]
             for c in seq_cols}
    firsts = {c: df[c][starts] for c in ("user_id", "device_class", "affiliate_id", "length")}
    n = len(trip_ids)
    perm = np.random.RandomState(42).permutation(n)
    n_valid = max(int(n * 0.2), 1)
    max_len = min(max(len(r) for r in lists["city_id"]), max_trip_len)
    cols = [
        create_categorical_column("utrip_id", vocab["utrip_id"], tags=(Tags.SESSION_ID,)),
        create_categorical_column("user_id", vocab["user_id"], tags=(Tags.USER, Tags.USER_ID)),
        create_categorical_column("device_class", vocab["device_class"], tags=(Tags.USER,)),
        create_categorical_column("affiliate_id", vocab["affiliate_id"], tags=("context",)),
        create_continuous_column("length"),
        create_categorical_column("city_id", vocab["city_id"],
                                  tags=(Tags.ITEM, Tags.ITEM_ID, Tags.SEQUENCE), is_list=True,
                                  max_seq_length=max_len),
    ]
    for c in ("booker_country", "hotel_country", "month", "weekday_checkin",
              "weekday_checkout", "is_weekend"):
        cols.append(create_categorical_column(c, vocab[c], tags=(Tags.SEQUENCE,), is_list=True,
                                              max_seq_length=max_len))
    for c in ("dayofweek_sin", "dayofweek_cos"):
        cols.append(create_continuous_column(c, tags=(Tags.SEQUENCE,), is_list=True,
                                             max_seq_length=max_len))

    def build(idx):
        data = {"utrip_id": trip_ids[idx].astype(np.int32),
                **{c: firsts[c][idx].astype(np.float32 if c == "length" else np.int32)
                   for c in ("user_id", "device_class", "affiliate_id", "length")}}
        for c in seq_cols:
            dtype = np.float32 if c.startswith("dayofweek") else np.int32
            rows = np.empty(len(idx), dtype=object)
            rows[:] = [lists[c][i].astype(dtype) for i in idx]
            data[c] = rows
        return Dataset({c.name: data[c.name] for c in cols}, schema=Schema(cols))

    return build(perm[:-n_valid]), build(perm[-n_valid:])


# ---------------------------------------------------------------------------
# Dressipi
# ---------------------------------------------------------------------------

def get_dressipi2022(path: Optional[str] = None, num_rows: int = 50_000,
                     category_coverage_min: float = 0.8) -> Pair:
    """Dressipi RecSys'22 sessions. With ``path`` holding the raw release
    (``train_sessions.csv``, ``train_purchases.csv``,
    ``item_features.csv``), :func:`_load_dressipi_raw`; else prepared
    parquet or synthesized from ``dressipi2022-preprocessed``."""
    if path is not None and os.path.isdir(path) and os.path.exists(
            os.path.join(path, "train_sessions.csv")):
        return _load_dressipi_raw(path, category_coverage_min)
    return _from_path_or_synthetic(path, "dressipi2022-preprocessed", num_rows)


_DRESSIPI_KEEP = [3, 4, 5, 17, 24, 30, 45, 46, 53, 55, 58, 63, 65, 73]
_DRESSIPI_DROP = [30, 4, 46, 28, 53, 1]


def _load_dressipi_raw(path: str, category_coverage_min: float) -> Pair:
    """The reference's preparation: the item features kept for the
    reference's categories and any covering at least
    ``category_coverage_min`` of the items, less its dropped set, pivoted to
    one ``f_<category>`` column each (-1 where missing); sessions and
    purchases joined with them, ``date`` as ``timestamp`` and ``day``; the
    last 30 days the validation split, each split joined with its sessions'
    purchases (``purchase_id``).

    ``timestamp`` is the date's integer value ``// 10**6``, as the JAX
    package computes it: seconds, since pandas 3 parses a date to
    microseconds (the JAX package's comment says milliseconds, which pandas
    2's nanoseconds gave)."""
    feats = _read_csv(os.path.join(path, "item_features.csv"))
    cat, item = feats["feature_category_id"], feats["item_id"]
    n_items = len(np.unique(item))
    counts = Counter(cat.tolist())
    covered = [c for c, k in counts.items() if k / n_items >= category_coverage_min]
    keep = (np.isin(cat, _DRESSIPI_KEEP) | np.isin(cat, covered)) & ~np.isin(cat, _DRESSIPI_DROP)
    feats = _take(feats, keep)
    items, item_pos = np.unique(feats["item_id"], return_inverse=True)
    cats, cat_pos = np.unique(feats["feature_category_id"], return_inverse=True)
    if len(set(zip(item_pos.tolist(), cat_pos.tolist()))) != len(item_pos):
        raise ValueError("Index contains duplicate entries, cannot reshape")  # pandas' pivot
    table = {"item_id": items}
    for j, c in enumerate(cats.tolist()):
        col = np.full(len(items), -1, np.int64)
        hit = cat_pos == j
        col[item_pos[hit]] = feats["feature_value_id"][hit]
        table[f"f_{c}"] = col

    def prep(df):
        df = _merge_left(df, table, "item_id")
        date = _dates(df["date"])
        df["date"] = date
        df["timestamp"] = date.astype(np.int64) // 10**6
        df = _take(df, np.lexsort((date, df["session_id"])))
        df["day"] = _days(df["date"] - df["date"].min())
        return df

    sessions = prep(_read_csv(os.path.join(path, "train_sessions.csv")))
    purchases = prep(_read_csv(os.path.join(path, "train_purchases.csv")))
    purchases["purchase_id"] = purchases.pop("item_id")

    cut = sessions["day"].max() - 30
    splits = []
    for mask in (sessions["day"] <= cut, sessions["day"] > cut):
        part = _take(sessions, mask)
        has = np.isin(purchases["session_id"], np.unique(part["session_id"]))
        pur = {k: purchases[k][has] for k in ("session_id", "purchase_id")}
        part = _merge_left(part, pur, "session_id")
        part.pop("date")
        splits.append({k: _fillna(v, -1) for k, v in part.items()})

    names = list(splits[0])
    cols = []
    for name in names:
        card = int(max(np.max(sp[name]) for sp in splits if len(sp[name])))
        if name == "timestamp":
            cols.append(ColumnSchema(name, dtype="int64"))
        elif name == "purchase_id":
            cols.append(create_categorical_column(name, card, tags=(Tags.TARGET,)))
        elif name == "item_id":
            cols.append(create_categorical_column(name, card, tags=(Tags.ITEM_ID, Tags.ITEM)))
        elif name == "session_id":
            cols.append(create_categorical_column(name, card,
                                                  tags=(Tags.SESSION, Tags.SESSION_ID)))
        else:
            cols.append(create_categorical_column(name, card, tags=(Tags.ITEM,)))
    schema = Schema(cols)
    return tuple(Dataset(sp, schema=schema) for sp in splits)


def _fillna(col: np.ndarray, value) -> np.ndarray:
    return np.where(np.isnan(col), value, col) if col.dtype.kind == "f" else col


# ---------------------------------------------------------------------------
# SIGIR, Tenrec, transactions
# ---------------------------------------------------------------------------

def get_sigir(path: Optional[str] = None, num_rows: int = 50_000,
              table: str = "browsing") -> Pair:
    """SIGIR'21 e-commerce challenge, ``table`` "browsing" or "sku":
    prepared parquet, else synthesized from its stored schema (the
    reference has no raw preparation)."""
    name = {"browsing": "sigir-browsing", "sku": "sigir-sku"}.get(table)
    if name is None:
        raise ValueError(f"table must be 'browsing' or 'sku', got {table!r}")
    return _from_path_or_synthetic(path, name, num_rows)


def get_tenrec(path: Optional[str] = None, num_rows: int = 50_000,
               table: str = "QK-video") -> Pair:
    """Tenrec multi-task feedback. With ``path`` holding ``<table>.csv``,
    :func:`_load_tenrec_raw`; else prepared parquet or synthesized from
    ``tenrec-video``."""
    if path is not None:
        raw = _load_tenrec_raw(path, table)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, "tenrec-video", num_rows)


def _load_tenrec_raw(path: str, table: str = "QK-video", seed: int = 42) -> Optional[Pair]:
    """Frequency Categorify (0 = missing) of the id and categorical
    columns, the feedback columns as int32 targets, ``watching_times``
    clipped to [0, 5] the regression target, an 80/20 split of the rows
    (RandomState(seed))."""
    path_csv = os.path.join(path, f"{table}.csv")
    if not os.path.exists(path_csv):
        return None
    df = _read_csv(path_csv)
    needed = {"user_id", "item_id", "click"}
    if not needed.issubset(df):
        raise ValueError(f"{path_csv} is missing required Tenrec columns "
                         f"{sorted(needed - set(df))}")
    vocab: Dict[str, int] = {}
    cat_cols = [c for c in ("user_id", "item_id", "video_category", "gender", "age") if c in df]
    for c in cat_cols:
        df[c], vocab[c] = _categorify_freq(df[c])
    tag_map = {"user_id": (Tags.USER, Tags.USER_ID), "item_id": (Tags.ITEM, Tags.ITEM_ID),
               "video_category": (Tags.ITEM,), "gender": (Tags.USER,), "age": (Tags.USER,)}
    cols = [create_categorical_column(c, vocab[c], tags=tag_map[c]) for c in cat_cols]
    target_cols = [c for c in ("click", "follow", "like", "share") if c in df]
    for c in target_cols:
        cols.append(ColumnSchema(c, tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
                                 dtype="int32"))
    has_watch = "watching_times" in df
    if has_watch:
        df["watching_times"] = np.clip(df["watching_times"], 0, 5)
        cols.append(ColumnSchema("watching_times", tags=(Tags.REGRESSION, Tags.TARGET),
                                 dtype="int32", int_domain=Domain(0, 5, is_categorical=False)))
    schema = Schema(cols)
    n = _rows(df)
    perm = np.random.RandomState(seed).permutation(n)
    n_valid = max(int(n * 0.2), 1)

    def build(idx):
        names = cat_cols + target_cols + (["watching_times"] if has_watch else [])
        return Dataset({c: df[c][idx].astype(np.int32) for c in names}, schema=schema)

    return build(perm[:-n_valid]), build(perm[-n_valid:])


def get_ecommerce_transactions(path: Optional[str] = None, num_rows: int = 50_000) -> Pair:
    """H&M-style purchase transactions. With ``path`` holding the raw
    ``transactions_train.csv``: frequency Categorify of the ids,
    standardized price (pandas' std, ddof 1), and the days after the 0.8
    quantile of ``t_dat`` the validation split (by position if none is
    later). Else prepared parquet or synthesized."""
    if path is not None:
        raw = _load_transactions_raw(path)
        if raw is not None:
            return raw
    return _from_path_or_synthetic(path, "transactions", num_rows)


def _load_transactions_raw(path: str) -> Optional[Pair]:
    path_csv = os.path.join(path, "transactions_train.csv")
    if not os.path.exists(path_csv):
        return None
    df = _read_csv(path_csv)
    df["t_dat"] = _dates(df["t_dat"])
    vocab: Dict[str, int] = {}
    for c in ("customer_id", "article_id", "sales_channel_id"):
        df[c], vocab[c] = _categorify_freq(df[c])
    price = df["price"].astype(np.float64)
    df["price"] = ((price - price.mean()) / max(price.std(ddof=1), 1e-12)).astype(np.float32)
    schema = Schema([
        create_categorical_column("customer_id", vocab["customer_id"],
                                  tags=(Tags.USER, Tags.USER_ID)),
        create_categorical_column("article_id", vocab["article_id"],
                                  tags=(Tags.ITEM, Tags.ITEM_ID)),
        create_categorical_column("sales_channel_id", vocab["sales_channel_id"],
                                  tags=("context",)),
        create_continuous_column("price"),
    ])
    df = _take(df, np.argsort(df["t_dat"], kind="stable"))
    t = df["t_dat"].astype(np.int64)
    cut = np.quantile(t.astype(np.float64), 0.8)
    tr, va = _take(df, t <= cut), _take(df, t > cut)
    if _rows(va) == 0:
        k = int(_rows(df) * 0.8)
        tr, va = _take(df, slice(None, k)), _take(df, slice(k, None))

    def build(d):
        return Dataset({"customer_id": d["customer_id"].astype(np.int32),
                        "article_id": d["article_id"].astype(np.int32),
                        "sales_channel_id": d["sales_channel_id"].astype(np.int32),
                        "price": d["price"].astype(np.float32)}, schema=schema)

    return build(tr), build(va)
