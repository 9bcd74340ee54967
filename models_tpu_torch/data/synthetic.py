"""Synthetic datasets from the known schemas.

Copies every schema that ``models_tpu/data/synthetic.py`` registers (twenty
names, ``music_streaming`` an alias of ``music-streaming``) and its numpy
draws, so that one seed gives the same rows in both packages, and its
``generate_data(set_sizes=)`` split. ``criteo`` has the published
Criteo 1TB cardinalities (26 tables, 31,457,706 rows); ``criteo-small`` the
same layout with 1000 ids a column. ``aliccp`` is the Ali-CCP click and
conversion log's layout (21 categorical columns, 3,448,362 rows of tables
in all, ``item_id`` 3,078,308 of them; two binary targets, ``click`` and
``conversion``); ``aliccp-small`` the same with every domain cut to at most
1001 ids. ``sequence-testing`` is the JAX package's
session schema: its list columns hold at most 4 positions (``max_seq_length``
4; ``generate_data``'s ``min_session_length`` / ``max_session_length`` draw
other lengths).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..schema import (
    ColumnSchema,
    Domain,
    Schema,
    Tags,
    create_categorical_column as cat,
    create_continuous_column as cont,
)
from .dataset import Dataset


def _binary_target(name: str, domain_max: int = 1) -> ColumnSchema:
    return ColumnSchema(
        name,
        tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
        dtype="int32",
        int_domain=Domain(0, domain_max, is_categorical=False),
    )


def _regression_target(name: str) -> ColumnSchema:
    return ColumnSchema(name, tags=(Tags.REGRESSION, Tags.TARGET), dtype="float32")


def _ecommerce_schema() -> Schema:
    user_cats = {
        "user_categories": 300, "user_shops": 500, "user_brands": 250,
        "user_intentions": 50, "user_profile": 20, "user_group": 14,
        "user_gender": 3, "user_age": 8, "user_consumption_1": 4,
        "user_consumption_2": 4, "user_is_occupied": 3, "user_geography": 5,
    }
    item_cats = {"item_category": 100, "item_shop": 500, "item_intention": 25, "item_brand": 250}
    cols: List[ColumnSchema] = []
    for name, card in user_cats.items():
        cols.append(cat(name, card, tags=Tags.USER))
    cols.append(cat("user_id", 1000, tags=(Tags.USER, Tags.USER_ID)))
    for name, card in item_cats.items():
        cols.append(cat(name, card, tags=Tags.ITEM))
    cols.append(cat("item_id", 1000, tags=(Tags.ITEM, Tags.ITEM_ID)))
    cols.append(cat("position", 4, tags=Tags.CONTEXT))
    for name, card in (
        ("user_item_categories", 300), ("user_item_shops", 500),
        ("user_item_brands", 250), ("user_item_intentions", 25),
    ):
        cols.append(cat(name, card, tags=("user_item",)))
    cols.append(_binary_target("click"))
    cols.append(_binary_target("conversion", domain_max=0))
    return Schema(cols)


def _movielens_25m_schema() -> Schema:
    return Schema(
        [
            cat("movieId", 56680, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cat("userId", 162541, tags=(Tags.USER, Tags.USER_ID)),
            cat("genres", 20, tags=Tags.ITEM, is_list=True, max_seq_length=10),
            cont("TE_movieId_rating", tags=Tags.ITEM),
            cont("userId_count", tags=Tags.USER),
            ColumnSchema("title", dtype="bytes"),
            _binary_target("rating_binary"),
            _regression_target("rating"),
        ]
    )


def _aliccp_schema() -> Schema:
    return Schema([
        cat("user_id", 294737, tags=(Tags.USER, Tags.USER_ID)),
        cat("item_id", 3078307, tags=(Tags.ITEM, Tags.ITEM_ID)),
        cat("item_category", 8582, tags=Tags.ITEM),
        cat("item_shop", 4532, tags=Tags.ITEM),
        cat("item_brand", 9996, tags=Tags.ITEM),
        cat("user_categories", 6087, tags=Tags.USER),
        cat("user_shops", 6736, tags=Tags.USER),
        cat("user_profile", 99, tags=Tags.USER),
        cat("user_group", 14, tags=Tags.USER),
        cat("user_gender", 3, tags=Tags.USER),
        cat("user_age", 8, tags=Tags.USER),
        cat("user_consumption_2", 4, tags=Tags.USER),
        cat("user_is_occupied", 3, tags=Tags.USER),
        cat("user_geography", 5, tags=Tags.USER),
        cat("user_intentions", 33787, tags=Tags.USER),
        cat("user_brands", 5429, tags=Tags.USER),
        cat("user_item_categories", 2),
        cat("user_item_shops", 2),
        cat("user_item_brands", 2),
        cat("user_item_intentions", 2),
        cat("position", 4, tags=Tags.CONTEXT),
        _binary_target("click"),
        _binary_target("conversion"),
    ])


def _aliccp_small_schema() -> Schema:
    """``aliccp`` with every integer domain above 1000 cut to 1000."""
    from dataclasses import replace

    return Schema([replace(c, int_domain=replace(c.int_domain, max=1000))
                   if c.int_domain is not None and c.int_domain.max > 1000 else c
                   for c in _aliccp_schema()])


# the Criteo 1TB click logs' 26 categorical cardinalities (the largest id of
# each column; the table takes one row more)
CRITEO_CARDINALITIES = (
    7599500, 33521, 17022, 7339, 20046, 4, 7068, 1377, 63, 5345303,
    561810, 242827, 11, 2209, 10616, 100, 4, 968, 15, 7838519,
    2580502, 6878028, 298771, 11951, 97, 35)


def _criteo_layout(cards) -> Schema:
    """13 continuous columns I1..I13, 26 categorical C1..C26, the binary
    ``label``."""
    cols: List[ColumnSchema] = [cont(f"I{i}", tags=Tags.CONTINUOUS) for i in range(1, 14)]
    cols += [cat(f"C{i}", card) for i, card in enumerate(cards, start=1)]
    cols.append(_binary_target("label"))
    return Schema(cols)


def _criteo_schema() -> Schema:
    return _criteo_layout(CRITEO_CARDINALITIES)


def _criteo_small_schema() -> Schema:
    return _criteo_layout([1000] * 26)


def _sequence_testing_schema() -> Schema:
    seq = (Tags.ITEM, Tags.SEQUENCE)
    L = 4  # the JAX schema's session length
    return Schema(
        [
            cat("test_user_id", 90, tags=(Tags.USER, Tags.USER_ID)),
            cont("item_age_days_norm", tags=seq, is_list=True, max_seq_length=L),
            cont("event_hour_sin", tags=seq, is_list=True, max_seq_length=L),
            cont("event_hour_cos", tags=seq, is_list=True, max_seq_length=L),
            cont("event_weekday_sin", tags=seq, is_list=True, max_seq_length=L),
            cont("event_weekday_cos", tags=seq, is_list=True, max_seq_length=L),
            cat("item_id_seq", 100, tags=(Tags.ITEM_ID,) + seq, is_list=True, max_seq_length=L),
            cat("categories", 331, tags=(Tags.LIST,) + seq, is_list=True, max_seq_length=L),
            cat("user_country", 62, tags=Tags.USER),
            cont("user_age", tags=Tags.USER),
            ColumnSchema("event_timestamp", dtype="int32"),
        ]
    )


def _movielens_100k_schema() -> Schema:
    return Schema(
        [
            cat("movieId", 1680, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cat("userId", 943, tags=(Tags.USER, Tags.USER_ID)),
            cat("genres", 216, tags=Tags.ITEM),
            cont("TE_movieId_rating", tags=Tags.CONTINUOUS),
            cat("gender", 2, tags=Tags.USER),
            cat("zip_code", 795, tags=Tags.USER),
            cat("age", 8, tags=Tags.USER),
            ColumnSchema("title", dtype="bytes"),
            cont("userId_count"),
            _binary_target("rating_binary"),
            _regression_target("rating"),
        ]
    )


def _music_streaming_schema() -> Schema:
    return Schema(
        [
            cat("session_id", 10000, tags=Tags.SESSION_ID),
            cat("item_id", 10000, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cat("item_category", 100, tags=Tags.ITEM),
            cont("item_recency", tags=Tags.ITEM),
            cat("item_genres", 100, tags=Tags.ITEM, is_list=True, max_seq_length=4),
            cat("user_id", 10000, tags=(Tags.USER, Tags.USER_ID)),
            cat("country", 100, tags=Tags.USER),
            ColumnSchema("user_age", tags=(Tags.USER, Tags.CONTINUOUS), dtype="int32",
                         int_domain=Domain(0, 50, is_categorical=False)),
            cat("user_genres", 100, tags=Tags.USER, is_list=True, max_seq_length=4),
            ColumnSchema("position", tags=("bias", Tags.CONTINUOUS), dtype="int32",
                         int_domain=Domain(0, 100, is_categorical=False)),
            _binary_target("click"),
            _regression_target("play_percentage"),
            _binary_target("like"),
        ]
    )


def _testing_schema() -> Schema:
    return Schema(
        [
            cat("user_id", 90, tags=(Tags.USER, Tags.USER_ID)),
            cont("item_age_days_norm", tags=Tags.ITEM),
            cont("event_hour_sin", tags=Tags.ITEM),
            cont("event_hour_cos", tags=Tags.ITEM),
            cont("event_weekday_sin", tags=Tags.ITEM),
            cont("event_weekday_cos", tags=Tags.ITEM),
            ColumnSchema("event_timestamp", dtype="int32"),
            cat("item_id", 100, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cat("categories", 70, tags=(Tags.ITEM, Tags.LIST), is_list=True, max_seq_length=4),
            cat("user_country", 62, tags=Tags.USER),
            cont("user_age", tags=Tags.USER),
        ]
    )


def _social_schema() -> Schema:
    cols = [
        cat("user_categories", 6086, tags=Tags.USER),
        cat("user_intentions", 33786, tags=Tags.USER),
        cat("user_profile", 98, tags=Tags.USER),
        cat("user_group", 14, tags=Tags.USER),
        cat("user_id", 294736, tags=(Tags.USER, Tags.USER_ID)),
        cat("user_age", 8, tags=Tags.USER),
        cat("user_consumption_1", 4, tags=Tags.USER),
        cat("user_gender", 3, tags=Tags.USER),
        cat("user_geography", 5, tags=Tags.USER),
        cat("user_is_occupied", 3, tags=Tags.USER),
        cat("item_category", 8581, tags=Tags.ITEM),
        cat("item_id", 3078306, tags=(Tags.ITEM, Tags.ITEM_ID)),
        cat("item_user_id", 294736, tags=Tags.ITEM),
        cat("position", 4, tags=Tags.CONTEXT),
    ]
    cols += [_binary_target(t, domain_max=0) for t in ("click", "like", "comment", "share", "hide")]
    return Schema(cols)


def _booking_schema() -> Schema:
    """The Booking.com next-destination challenge's layout: per-trip city
    sequences and the trip's context (a session dataset)."""
    return Schema(
        [
            cat("utrip_id", 217686, tags=Tags.SESSION_ID),
            cat(
                "city_id", 39901, tags=(Tags.ITEM, Tags.ITEM_ID, Tags.SEQUENCE),
                is_list=True, max_seq_length=10,
            ),
            cat(
                "booker_country", 5, tags=(Tags.USER, Tags.SEQUENCE),
                is_list=True, max_seq_length=10,
            ),
            cat("device_class", 3, tags=Tags.USER),
            cat("affiliate_id", 3254, tags=Tags.CONTEXT),
            cat("month_checkin", 12, tags=Tags.CONTEXT),
        ]
    )


def _movielens_1m_schema() -> Schema:
    return Schema(
        [
            cat("userId", 6040, tags=(Tags.USER, Tags.USER_ID)),
            cat("movieId", 3684, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cat("title", 3684),
            cat("genres", 18, tags=Tags.ITEM, is_list=True, max_seq_length=1),
            cat("gender", 2),
            cat("age", 7),
            cat("occupation", 21),
            cat("zipcode", 3439),
            cont("TE_age_rating", tags=Tags.USER),
            cont("TE_gender_rating", tags=Tags.USER),
            cont("TE_occupation_rating", tags=Tags.USER),
            cont("TE_zipcode_rating", tags=Tags.USER),
            cont("TE_movieId_rating", tags=Tags.ITEM),
            cont("TE_userId_rating", tags=Tags.USER),
            ColumnSchema("rating_binary", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET),
                         dtype="int32"),
            _regression_target("rating"),
        ]
    )


def _transactions_schema() -> Schema:
    """An H&M-style purchase log: customer_id (1,362,282 ids), article_id
    (104,548), sales_channel_id (3), the standardized price."""
    return Schema(
        [
            cat("customer_id", 1_362_281, tags=(Tags.USER, Tags.USER_ID, "id")),
            cat("article_id", 104_547, tags=(Tags.ITEM, Tags.ITEM_ID, "id")),
            cat("sales_channel_id", 2),
            cont("price"),
        ]
    )


def _tenrec_video_schema() -> Schema:
    return Schema(
        [
            cat("user_id", 100_000, tags=(Tags.USER, Tags.USER_ID, "id")),
            cat("item_id", 179_280, tags=(Tags.ITEM, Tags.ITEM_ID, "id")),
            cat("video_category", 5, tags=Tags.ITEM),
            cat("gender", 5, tags=Tags.USER),
            cat("age", 10, tags=Tags.USER),
            ColumnSchema("click", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="int32"),
            ColumnSchema("follow", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="int32"),
            ColumnSchema("like", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="int32"),
            ColumnSchema("share", tags=(Tags.BINARY_CLASSIFICATION, Tags.TARGET), dtype="int32"),
            ColumnSchema("watching_times", tags=(Tags.REGRESSION, Tags.TARGET), dtype="int32",
                         int_domain=Domain(0, 5, is_categorical=False)),
        ]
    )


def _ecommerce_large_schema() -> Schema:
    user_cats = {
        "user_categories": 6086, "user_shops": 116741, "user_brands": 58015,
        "user_intentions": 33786, "user_profile": 98, "user_group": 14,
        "user_gender": 3, "user_age": 8, "user_consumption_1": 4,
        "user_consumption_2": 4, "user_is_occupied": 3, "user_geography": 5,
    }
    item_cats = {
        "item_category": 8581, "item_shop": 604498, "item_intention": 96258,
        "item_brand": 208179,
    }
    cross_cats = {
        "user_item_categories": 7735, "user_item_shops": 384343,
        "user_item_brands": 142632, "user_item_intentions": 74317,
    }
    cols: List[ColumnSchema] = []
    for name, card in user_cats.items():
        cols.append(cat(name, card, tags=Tags.USER))
    cols.append(cat("user_id", 294736, tags=(Tags.USER, Tags.USER_ID)))
    for name, card in item_cats.items():
        cols.append(cat(name, card, tags=Tags.ITEM))
    cols.append(cat("item_id", 3078306, tags=(Tags.ITEM, Tags.ITEM_ID)))
    for name, card in cross_cats.items():
        cols.append(cat(name, card, tags=("user_item",)))
    cols.append(cat("position", 4, tags=Tags.CONTEXT))
    cols.append(_binary_target("click", domain_max=0))
    cols.append(_binary_target("conversion", domain_max=0))
    return Schema(cols)


def _sigir_browsing_schema() -> Schema:
    """The SIGIR'21 e-commerce challenge's browsing events."""
    return Schema(
        [
            cat("session_id_hash", 999, tags=(Tags.ITEM_ID, Tags.ITEM)),
            cat("event_type", 2),
            cat("product_action", 4),
            cat("product_sku_hash", 999),
            cat("hashed_url", 999),
            cont("server_timestamp_epoch_ms"),
        ]
    )


def _sigir_sku_schema() -> Schema:
    """The SIGIR'21 challenge's SKU side information: ``description_vector``
    is a 50-wide dense float list."""
    return Schema(
        [
            cat("product_sku_hash", 999, tags=(Tags.ITEM,)),
            cont("description_vector", tags=(Tags.ITEM,), is_list=True, max_seq_length=50),
            cat("category_hash", 174, tags=(Tags.ITEM, Tags.ITEM_ID)),
            cont("price_bucket"),
        ]
    )


def _dressipi_schema() -> Schema:
    """Dressipi's RecSys'22 sessions, preprocessed: session views joined
    with the pivoted item feature categories (f_*) and the purchased item."""
    feats = {
        "f_3": 7, "f_5": 13, "f_7": 37, "f_17": 6, "f_24": 4, "f_45": 10,
        "f_47": 18, "f_50": 25, "f_55": 51, "f_56": 68, "f_58": 7, "f_61": 7,
        "f_63": 25, "f_65": 13, "f_68": 50, "f_69": 31, "f_72": 27, "f_73": 4,
    }
    cols = [
        cat("session_id", 920831, tags=(Tags.SESSION, Tags.SESSION_ID)),
        cat("date", 4284223),
    ]
    cols += [cat(name, card, tags=Tags.ITEM) for name, card in feats.items()]
    cols += [
        cat("timestamp", 4284223),
        cat("day", 485),
        cat("purchase_id", 18544, tags=(Tags.TARGET,)),
        cat("item_id", 23145, tags=(Tags.ITEM_ID, Tags.ITEM)),
    ]
    return Schema(cols)


KNOWN_DATASETS: Dict[str, Callable[[], Schema]] = {
    "e-commerce": _ecommerce_schema,
    "music-streaming": _music_streaming_schema,
    "music_streaming": _music_streaming_schema,
    "sequence-testing": _sequence_testing_schema,
    "testing": _testing_schema,
    "social": _social_schema,
    "movielens-100k": _movielens_100k_schema,
    "movielens-1m": _movielens_1m_schema,
    "movielens-25m": _movielens_25m_schema,
    "tenrec-video": _tenrec_video_schema,
    "e-commerce-large": _ecommerce_large_schema,
    "aliccp": _aliccp_schema,
    "aliccp-small": _aliccp_small_schema,
    "criteo": _criteo_schema,
    "criteo-small": _criteo_small_schema,
    "booking": _booking_schema,
    "sigir-browsing": _sigir_browsing_schema,
    "sigir-sku": _sigir_sku_schema,
    "transactions": _transactions_schema,
    "dressipi2022-preprocessed": _dressipi_schema,
}


def known_schema(name: str) -> Schema:
    if name not in KNOWN_DATASETS:
        raise ValueError(f"Unknown dataset {name!r}. Known: {sorted(KNOWN_DATASETS)}")
    return KNOWN_DATASETS[name]()


def generate_data(
    input: Union[str, Schema],
    num_rows: int = 100,
    set_sizes: Sequence[float] = (1.0,),
    seed: int = 42,
    min_session_length: Optional[int] = None,
    max_session_length: Optional[int] = None,
) -> Union[Dataset, List[Dataset]]:
    """A random dataset honouring the schema's domains. A list column's rows
    take lengths uniform in [``min_session_length``, ``max_session_length``]
    (default: half the column's ``max_seq_length``, and that length).
    ``set_sizes=(0.8, 0.2)`` returns a [train, valid] list, split by
    :meth:`Dataset.split` with ``seed`` (the JAX package's contract)."""
    schema = known_schema(input) if isinstance(input, str) else input
    rng = np.random.default_rng(seed)
    data = {
        col.name: _sample_column(col, num_rows, rng, min_session_length, max_session_length)
        for col in schema
    }
    ds = Dataset(data, schema=schema)
    if tuple(set_sizes) == (1.0,):
        return ds
    return ds.split(set_sizes, seed=seed)


def _sample_column(col, num_rows, rng, min_len, max_len):
    if col.is_list:
        length = max_len or col.max_seq_length or 4
        low = min_len if min_len is not None else max(1, length // 2)
        lengths = rng.integers(low, length + 1, size=num_rows)
        rows = [_sample_values(col, int(n), rng) for n in lengths]
        return np.array([np.asarray(r) for r in rows], dtype=object)
    return _sample_values(col, num_rows, rng)


def _sample_values(col: ColumnSchema, n: int, rng: np.random.Generator) -> np.ndarray:
    if col.dtype == "bytes":
        ids = rng.integers(0, max(n, 10), size=n)
        return np.array([f"{col.name}_{i}" for i in ids])
    if col.int_domain is not None and col.int_domain.is_categorical:
        card = col.cardinality
        # mild popularity skew; id 0 reserved
        lo = max(col.int_domain.min, 1) if card > 2 else col.int_domain.min
        probs = 1.0 / np.arange(lo + 1, card + 1) ** 0.75
        probs /= probs.sum()
        return rng.choice(np.arange(lo, card), size=n, p=probs).astype(np.int32)
    if col.has_tag(Tags.BINARY_CLASSIFICATION) or (col.is_target and col.dtype.startswith("int")):
        return rng.integers(0, 2, size=n).astype(np.int32)
    if col.dtype.startswith("int"):
        hi = col.int_domain.max + 1 if col.int_domain else 100
        return rng.integers(0, hi, size=n).astype(np.int32)
    if col.float_domain:
        lo = col.float_domain[0] or 0.0
        hi = col.float_domain[1] or 1.0
        return rng.uniform(lo, hi, size=n).astype(np.float32)
    return rng.normal(size=n).astype(np.float32)
