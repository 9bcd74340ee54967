"""Schema: tagged column descriptions that drive model construction.

A copy of the serving subset of ``models_tpu/schema.py`` (the port imports
nothing of the JAX package). A ``Schema`` is an ordered collection of
``ColumnSchema`` objects, each carrying semantic ``Tags``, dtype, list-ness and,
for categorical columns, an integer domain with a known cardinality. It
reads and writes the TF-metadata JSON layout (``to_dict``, ``save``,
``load``): the ``.merlin/`` sidecars of a saved model, byte-equal to the
JAX package's for the same schema. It reads the TF-metadata text layout too
(``from_pbtxt``, ``load_pbtxt``: the ``schema.pbtxt`` sidecar NVTabular
writes beside a dataset's parquet files).
"""

from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union


class Tags(str, Enum):
    """Semantic column tags (the values of merlin-core ``Tags``)."""

    USER = "user"
    ITEM = "item"
    SESSION = "session"
    CONTEXT = "context"

    USER_ID = "user_id"
    ITEM_ID = "item_id"
    SESSION_ID = "session_id"

    CATEGORICAL = "categorical"
    CONTINUOUS = "continuous"
    LIST = "list"
    SEQUENCE = "sequence"
    TEXT = "text"
    EMBEDDING = "embedding"
    TOKENIZED = "tokenized"
    TIME = "time"

    TARGET = "target"
    BINARY_CLASSIFICATION = "binary_classification"
    MULTI_CLASS_CLASSIFICATION = "multi_class_classification"
    REGRESSION = "regression"

    def __str__(self) -> str:
        return self.value


TagLike = Union[str, Tags]


def _norm_tag(tag: TagLike) -> str:
    return tag.value if isinstance(tag, Tags) else str(tag)


def _norm_tags(tags: Union[TagLike, Iterable[TagLike], None]) -> Tuple[str, ...]:
    if tags is None:
        return ()
    if isinstance(tags, (str, Tags)):
        return (_norm_tag(tags),)
    return tuple(_norm_tag(t) for t in tags)


@dataclass(frozen=True)
class Domain:
    """Integer domain of a column. ``max`` is inclusive, so the cardinality of a
    categorical column is ``max + 1``."""

    min: int = 0
    max: int = 0
    name: Optional[str] = None
    is_categorical: bool = True

    @property
    def cardinality(self) -> int:
        return int(self.max) + 1


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    tags: Tuple[str, ...] = ()
    dtype: str = "float32"
    is_list: bool = False
    is_ragged: bool = False
    int_domain: Optional[Domain] = None
    float_domain: Optional[Tuple[float, float]] = None
    # (min_count, max_count) for list columns; max_count is the pad length
    value_count: Optional[Tuple[int, int]] = None
    properties: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "tags", _norm_tags(self.tags))

    def has_tag(self, tag: TagLike) -> bool:
        return _norm_tag(tag) in self.tags

    def has_any_tag(self, tags: Iterable[TagLike]) -> bool:
        return any(self.has_tag(t) for t in tags)

    def has_all_tags(self, tags: Iterable[TagLike]) -> bool:
        return all(self.has_tag(t) for t in tags)

    def with_tags(self, tags: Union[TagLike, Iterable[TagLike]]) -> "ColumnSchema":
        return replace(self, tags=tuple(dict.fromkeys(self.tags + _norm_tags(tags))))

    def without_tags(self, tags: Union[TagLike, Iterable[TagLike]]) -> "ColumnSchema":
        drop = set(_norm_tags(tags))
        return replace(self, tags=tuple(t for t in self.tags if t not in drop))

    def with_name(self, name: str) -> "ColumnSchema":
        return replace(self, name=name)

    def with_properties(self, **props) -> "ColumnSchema":
        return replace(self, properties={**self.properties, **props})

    @property
    def is_categorical(self) -> bool:
        return self.has_tag(Tags.CATEGORICAL)

    @property
    def is_continuous(self) -> bool:
        return self.has_tag(Tags.CONTINUOUS)

    @property
    def is_target(self) -> bool:
        return self.has_tag(Tags.TARGET)

    @property
    def cardinality(self) -> Optional[int]:
        return self.int_domain.cardinality if self.int_domain else None

    @property
    def domain_name(self) -> str:
        """Shared-embedding key: columns with the same int-domain name share a table."""
        if self.int_domain and self.int_domain.name:
            return self.int_domain.name
        return self.name

    @property
    def max_seq_length(self) -> int:
        """Pad length of a list column (0 for scalars)."""
        if not self.is_list:
            return 0
        if self.value_count:
            return int(self.value_count[1])
        return int(self.properties.get("max_seq_length", 0))


class Schema:
    """Ordered, name-keyed collection of ``ColumnSchema``."""

    def __init__(self, columns: Union[Iterable[ColumnSchema], Iterable[str], None] = None):
        cols: List[ColumnSchema] = []
        for c in columns or ():
            cols.append(ColumnSchema(c) if isinstance(c, str) else c)
        self._by_name: Dict[str, ColumnSchema] = {c.name: c for c in cols}

    def __iter__(self) -> Iterator[ColumnSchema]:
        return iter(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_name)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __getitem__(self, name: str) -> ColumnSchema:
        return self._by_name[name]

    def get(self, name: str, default=None) -> Optional[ColumnSchema]:
        return self._by_name.get(name, default)

    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and self._by_name == other._by_name

    def __repr__(self) -> str:
        return "Schema([" + ", ".join(f"{c.name}{list(c.tags)}" for c in self) + "])"

    @property
    def column_names(self) -> List[str]:
        return list(self._by_name)

    @property
    def column_schemas(self) -> List[ColumnSchema]:
        return list(self._by_name.values())

    @property
    def first(self) -> ColumnSchema:
        return next(iter(self._by_name.values()))

    def copy(self) -> "Schema":
        return Schema(copy.deepcopy(self.column_schemas))

    def select_by_tag(self, tags: Union[TagLike, Iterable[TagLike]]) -> "Schema":
        want = set(_norm_tags(tags))
        return Schema([c for c in self if want & set(c.tags)])

    def select_by_all_tags(self, tags: Iterable[TagLike]) -> "Schema":
        return Schema([c for c in self if c.has_all_tags(tags)])

    def select_by_name(self, names: Union[str, Iterable[str]]) -> "Schema":
        """The named columns that exist, in the order given."""
        names = [names] if isinstance(names, str) else list(names)
        return Schema([self._by_name[n] for n in names if n in self._by_name])

    def __add__(self, other: "Schema") -> "Schema":
        merged = dict(self._by_name)
        for c in other:
            merged[c.name] = c
        return Schema(merged.values())

    def map(self, fn) -> "Schema":
        return Schema([fn(c) for c in self])

    def cardinalities(self) -> Dict[str, int]:
        return {c.name: c.cardinality for c in self
                if c.int_domain is not None and c.int_domain.is_categorical}

    def excluding_by_tag(self, tags: Union[TagLike, Iterable[TagLike]]) -> "Schema":
        drop = set(_norm_tags(tags))
        return Schema([c for c in self if not (drop & set(c.tags))])

    # merlin-core aliases
    remove_by_tag = excluding_by_tag

    def excluding_by_name(self, names: Union[str, Iterable[str]]) -> "Schema":
        drop = {names} if isinstance(names, str) else set(names)
        return Schema([c for c in self if c.name not in drop])

    remove_col = excluding_by_name

    @property
    def categorical(self) -> "Schema":
        return self.select_by_tag(Tags.CATEGORICAL).excluding_by_tag(Tags.TARGET)

    @property
    def continuous(self) -> "Schema":
        return self.select_by_tag(Tags.CONTINUOUS).excluding_by_tag(Tags.TARGET)

    @property
    def targets(self) -> "Schema":
        return self.select_by_tag(Tags.TARGET)

    @property
    def user_id_column(self) -> ColumnSchema:
        sel = self.select_by_tag(Tags.USER_ID)
        if not len(sel):
            raise ValueError("Schema has no column tagged user_id")
        return sel.first

    @property
    def item_id_column(self) -> ColumnSchema:
        sel = self.select_by_tag(Tags.ITEM_ID)
        if not len(sel):
            raise ValueError("Schema has no column tagged item_id")
        return sel.first

    # ---- the TF-metadata JSON layout (models_tpu/schema.py:293-440) -------
    def to_dict(self) -> dict:
        feats = []
        for c in self:
            f: dict = {"name": c.name}
            if c.dtype.startswith("int") or c.dtype.startswith("uint"):
                f["type"] = "INT"
            elif c.dtype.startswith("float") or c.dtype.startswith("bfloat"):
                f["type"] = "FLOAT"
            else:
                f["type"] = "BYTES"
            if c.is_list and c.value_count:
                f["valueCount"] = {"min": str(c.value_count[0]), "max": str(c.value_count[1])}
            if c.int_domain:
                d: dict = {"name": c.int_domain.name or c.name}
                if c.int_domain.min:
                    d["min"] = str(int(c.int_domain.min))
                d["max"] = str(int(c.int_domain.max))
                if c.int_domain.is_categorical:
                    d["isCategorical"] = True
                f["intDomain"] = d
            extra = {"is_list": c.is_list, "is_ragged": c.is_ragged, "dtype_item_size": 32.0,
                     **c.properties}
            f["annotation"] = {"tag": list(c.tags), "extraMetadata": [extra]}
            feats.append(f)
        return {"feature": feats}

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, data: dict) -> "Schema":
        cols = []
        for f in data.get("feature", []):
            name = f["name"]
            ftype = f.get("type", "FLOAT")
            ann = f.get("annotation", {}) or {}
            extra_list = ann.get("extraMetadata", []) or []
            extra = dict(extra_list[0]) if extra_list else {}
            value_count = None
            if "valueCount" in f:
                vc = f["valueCount"]
                vmin, vmax = int(vc.get("min", 0)), int(vc.get("max", 0))
                # NVTabular writes {min: N} alone for lists of fixed length N
                value_count = (vmin, vmax or vmin)
            int_domain = None
            if "intDomain" in f:
                d = f["intDomain"]
                int_domain = Domain(min=int(d.get("min", 0)), max=int(d.get("max", 0)),
                                    name=d.get("name") or name,
                                    is_categorical=bool(d.get("isCategorical", False)))
            if ftype == "INT":
                dtype = "int64" if extra.get("dtype_item_size", 32.0) == 64.0 else "int32"
            else:
                dtype = "float32" if ftype == "FLOAT" else "bytes"
            cols.append(ColumnSchema(
                name=name, tags=tuple(ann.get("tag", []) or []), dtype=dtype,
                is_list=bool(extra.get("is_list", False)) or "valueCount" in f,
                is_ragged=bool(extra.get("is_ragged", False)), int_domain=int_domain,
                value_count=value_count,
                properties={k: v for k, v in extra.items()
                            if k not in ("is_list", "is_ragged", "dtype_item_size", "_dims")}))
        return cls(cols)

    @classmethod
    def from_json(cls, text: str) -> "Schema":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_pbtxt(cls, text: str) -> "Schema":
        """Parse the TF-metadata ``schema.pbtxt`` text format (the other layout
        NVTabular emits, e.g. the reference's Ali-CCP/Criteo schemas). Minimal
        recursive text-proto reader covering feature/int_domain/value_count/
        annotation.tag; binary extra_metadata blobs are skipped."""
        feats = []
        for block in _pbtxt_blocks(text, "feature"):
            f: dict = {}
            name = _pbtxt_scalar(block, "name")
            if name:
                f["name"] = name.strip('"')
            ftype = _pbtxt_scalar(block, "type")
            if ftype:
                f["type"] = ftype
            dom = next(iter(_pbtxt_blocks(block, "int_domain")), None)
            if dom is not None:
                d = {"name": (_pbtxt_scalar(dom, "name") or "").strip('"') or f.get("name")}
                for key in ("min", "max"):
                    v = _pbtxt_scalar(dom, key)
                    if v is not None:
                        d[key] = v
                if (_pbtxt_scalar(dom, "is_categorical") or "").lower() == "true":
                    d["isCategorical"] = True
                f["intDomain"] = d
            vc = next(iter(_pbtxt_blocks(block, "value_count")), None)
            if vc is not None:
                f["valueCount"] = {
                    k: _pbtxt_scalar(vc, k) or "0" for k in ("min", "max")
                }
            ann = next(iter(_pbtxt_blocks(block, "annotation")), None)
            tags = []
            is_list = vc is not None
            if ann is not None:
                import re as _re

                tags = [m.group(1) for m in _re.finditer(r'tag:\s*"([^"]+)"', ann)]
            f["annotation"] = {
                "tag": tags,
                "extraMetadata": [{"is_list": is_list, "is_ragged": is_list}],
            }
            feats.append(f)
        return cls.from_dict({"feature": feats})

    @classmethod
    def load_pbtxt(cls, path) -> "Schema":
        with open(path) as f:
            return cls.from_pbtxt(f.read())

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path) -> "Schema":
        with open(path) as f:
            return cls.from_json(f.read())


def _pbtxt_blocks(text: str, name: str):
    """Yield the brace-delimited bodies of `name { ... }` blocks (depth-aware)."""
    i = 0
    n = len(text)
    while True:
        idx = text.find(name, i)
        if idx < 0:
            return
        j = idx + len(name)
        while j < n and text[j] in " \t\r\n":
            j += 1
        if j >= n or text[j] != "{":
            i = idx + len(name)
            continue
        depth = 0
        start = j
        while j < n:
            if text[j] == "{":
                depth += 1
            elif text[j] == "}":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        yield text[start + 1 : j]
        i = j + 1


def _pbtxt_scalar(block: str, key: str):
    """First top-level `key: value` in a block (ignores nested blocks)."""
    import re as _re

    depth = 0
    for line in block.splitlines():
        stripped = line.strip()
        if depth == 0:
            m = _re.match(rf"{key}\s*:\s*(.+)", stripped)
            if m:
                return m.group(1).strip()
        depth += stripped.count("{") - stripped.count("}")
    return None


def infer_embedding_dim(
    col: ColumnSchema, multiplier: float = 2.0, ensure_multiple_of_8: bool = True
) -> int:
    """``multiplier * cardinality**0.25``, rounded up to a multiple of 8."""
    card = col.cardinality
    if card is None:
        raise ValueError(f"Column {col.name} has no int domain; cannot infer embedding dim")
    dim = int(math.ceil(multiplier * card ** 0.25))
    if ensure_multiple_of_8:
        dim = int(math.ceil(dim / 8) * 8)
    return max(dim, 8)


def categorical_cardinalities(schema: Schema) -> Dict[str, int]:
    return schema.categorical.cardinalities()


def categorical_domains(schema: Schema) -> Dict[str, str]:
    """Each categorical column's shared domain name (its table's key)."""
    return {c.name: c.domain_name for c in schema.categorical}


def create_categorical_column(
    name: str,
    num_items: int,
    tags: Union[TagLike, Iterable[TagLike], None] = None,
    is_list: bool = False,
    max_seq_length: int = 0,
    domain_name: Optional[str] = None,
) -> ColumnSchema:
    tags = _norm_tags(tags) + (Tags.CATEGORICAL.value,)
    return ColumnSchema(
        name=name,
        tags=tuple(dict.fromkeys(tags)),
        dtype="int32",
        is_list=is_list,
        is_ragged=is_list,
        int_domain=Domain(min=0, max=num_items, name=domain_name or name),
        value_count=(0, max_seq_length) if is_list else None,
    )


def create_continuous_column(
    name: str,
    tags: Union[TagLike, Iterable[TagLike], None] = None,
    is_list: bool = False,
    max_seq_length: int = 0,
    min_value: Optional[float] = None,
    max_value: Optional[float] = None,
) -> ColumnSchema:
    tags = _norm_tags(tags) + (Tags.CONTINUOUS.value,)
    fd = (min_value, max_value) if min_value is not None or max_value is not None else None
    return ColumnSchema(
        name=name,
        tags=tuple(dict.fromkeys(tags)),
        dtype="float32",
        is_list=is_list,
        is_ragged=is_list,
        float_domain=fd,
        value_count=(0, max_seq_length) if is_list else None,
    )
