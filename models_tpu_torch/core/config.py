"""A model's architecture as a constructor-replay tree
(``models_tpu/core/config.py``).

Every :class:`~models_tpu_torch.core.block.Block` records the arguments of
its outermost constructor call (:func:`record_init`) in a weak side table
kept outside the module, so that ``state_dict``, ``deepcopy`` and
``nn.Module.__setattr__`` never see it. :func:`to_config` turns a block into
a JSON tree of ``{"__block__": "module:QualName", "args": [...], "kwargs":
{...}}`` nodes; :func:`from_config` imports each class by path and calls it
again. A block met twice (a weight-tied table in the input block and in the
head) is written once and referred to by its id, so that it is one module
after the replay. A block's ``block_name``, ``schema`` and frozen flag, and
the calls recorded with :func:`record_call` (a transformer's
``set_in_features``), are replayed after its constructor.

Values: JSON scalars, tuples, lists, dicts of string keys, enums, schemas
(the TF-metadata layout, each distinct schema written once), torch dtypes,
numpy arrays and torch tensors (small ones inline, others in the side
arrays that ``utils/io.py`` stores beside the state; a bf16 tensor as its
bit pattern with its dtype recorded, since numpy has no bf16). Anything
else (a lambda, a loss function of the caller's) goes as a pickled leaf.

A constructor's ``device`` is never replayed: :func:`from_config` passes
its own ``device`` to every constructor that takes one.
"""

from __future__ import annotations

import base64
import copy
import enum
import importlib
import inspect
import json
import pickle
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# block -> (args, kwargs) of its outermost constructor call
_INIT_ARGS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
# block -> [(method name, args, kwargs)] recorded after construction
_CALLS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_TORCH_DTYPES = {str(d).split(".")[-1]: d for d in (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int8, torch.uint8,
    torch.int16, torch.int32, torch.int64, torch.bool)}


def record_init(obj, args, kwargs) -> None:
    """Record ``obj``'s constructor arguments; the outermost call wins (a
    subclass's ``super().__init__`` call comes after its own)."""
    if obj not in _INIT_ARGS:
        _INIT_ARGS[obj] = (tuple(args), dict(kwargs))


def record_call(obj, method: str, *args, **kwargs) -> None:
    """Record a call that changed ``obj`` after its construction, to be
    replayed after it (``device`` replaced, as a constructor's); it takes
    the place of an earlier record of the same method."""
    calls = [c for c in _CALLS.get(obj, []) if c[0] != method]
    _CALLS[obj] = calls + [(method, args, kwargs)]


def set_init_arg(obj, name: str, value) -> None:
    """Put ``value`` in the place of the recorded constructor argument
    ``name`` (given by keyword or by position): an argument whose effect is
    in the block's state, which the config need not carry."""
    args, kwargs = _INIT_ARGS[obj]
    if name in kwargs:
        _INIT_ARGS[obj] = (args, {**kwargs, name: value})
        return
    names = [p.name for p in inspect.signature(type(obj).__init__).parameters.values()][1:]
    if name in names[:len(args)]:
        i = names.index(name)
        _INIT_ARGS[obj] = (args[:i] + (value,) + args[i + 1:], kwargs)


def init_args_of(obj) -> Optional[Tuple[tuple, dict]]:
    return _INIT_ARGS.get(obj)


def copy_captures(original, copied, memo: dict) -> None:
    """Give ``copied`` (a deep copy of ``original`` made with ``memo``) the
    original's records, their blocks mapped to their copies."""
    for table in (_INIT_ARGS, _CALLS):
        rec = table.get(original)
        if rec is not None:
            table[copied] = copy.deepcopy(rec, memo)


class ConfigError(ValueError):
    pass


def _class_path(cls) -> str:
    if "<locals>" in cls.__qualname__:
        raise ConfigError(f"{cls.__qualname__} is defined inside a function and cannot be "
                          "imported by path; define it at module level to save it as a config")
    return f"{cls.__module__}:{cls.__qualname__}"


def _import_class(path: str):
    mod, qual = path.split(":")
    obj = importlib.import_module(mod)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _array_node(arr: np.ndarray, dtype: str, arrays: Dict[str, np.ndarray]) -> dict:
    if arr.size <= 16 and arr.dtype.kind in "iufb":
        return {"__array__": arr.tolist(), "dtype": dtype, "shape": list(arr.shape)}
    key = f"cfg_arr_{len(arrays)}"
    arrays[key] = arr
    return {"__array_ref__": key, "dtype": dtype}


class _Encoder:
    def __init__(self):
        self.memo: Dict[int, int] = {}
        self.arrays: Dict[str, np.ndarray] = {}
        self.schemas: List[dict] = []
        self._schema_ids: Dict[str, int] = {}
        self._n = 0

    def schema(self, schema) -> dict:
        d = schema.to_dict()
        key = json.dumps(d, sort_keys=True)
        if key not in self._schema_ids:
            self._schema_ids[key] = len(self.schemas)
            self.schemas.append(d)
        return {"__schema__": self._schema_ids[key]}

    def encode(self, v) -> Any:
        from ..schema import ColumnSchema, Schema
        from .block import Block

        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, enum.Enum):
            return {"__enum__": _class_path(type(v)), "value": v.value}
        if isinstance(v, torch.dtype):
            return {"__torch_dtype__": str(v).split(".")[-1]}
        if isinstance(v, np.dtype):
            return {"__dtype__": v.name}
        if isinstance(v, torch.device):
            return {"__device__": str(v)}
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu()
            name = str(t.dtype).split(".")[-1]
            arr = t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
            return {"__tensor__": _array_node(np.ascontiguousarray(arr), name, self.arrays)}
        if isinstance(v, (np.ndarray, np.generic)):
            arr = np.asarray(v)
            if arr.dtype.kind in "iufb":
                node = _array_node(np.ascontiguousarray(arr), arr.dtype.name, self.arrays)
                return node if isinstance(v, np.ndarray) else {"__scalar__": node}
        if isinstance(v, Schema):
            return self.schema(v)
        if isinstance(v, ColumnSchema):
            return {"__column__": self.schema(Schema([v]))}
        if isinstance(v, tuple) and not hasattr(v, "_fields"):
            return {"__tuple__": [self.encode(x) for x in v]}
        if isinstance(v, list):
            return [self.encode(x) for x in v]
        if isinstance(v, dict) and type(v) is dict:
            if not all(isinstance(k, str) for k in v):
                raise ConfigError("a dict with keys that are not strings")
            return {"__dict__": {k: self.encode(x) for k, x in v.items()}}
        if isinstance(v, Block):
            return self.block(v)
        if isinstance(v, torch.nn.Module):
            raise ConfigError(f"{type(v).__name__} is not a Block: it has no recorded "
                              "constructor arguments")
        try:
            payload = base64.b64encode(pickle.dumps(v)).decode("ascii")
        except Exception as err:
            raise ConfigError(f"cannot serialize {type(v).__name__}: {err}") from err
        return {"__pickle__": payload, "type": type(v).__name__}

    def block(self, v) -> dict:
        if id(v) in self.memo:
            return {"__ref__": self.memo[id(v)]}
        captured = init_args_of(v)
        if captured is None:
            raise ConfigError(f"{type(v).__name__} has no recorded constructor arguments")
        idx = self._n
        self._n += 1
        self.memo[id(v)] = idx
        args, kwargs = captured
        node = {"__block__": _class_path(type(v)), "id": idx,
                "args": [self.encode(a) for a in args],
                "kwargs": {k: self.encode(a) for k, a in kwargs.items()}}
        if getattr(v, "block_name", None) is not None:
            node["block_name"] = v.block_name
        if getattr(v, "schema", None) is not None:
            node["schema"] = self.schema(v.schema)
        if getattr(v, "_frozen", False):
            node["frozen"] = True
        calls = _CALLS.get(v)
        if calls:
            node["calls"] = [[m, [self.encode(a) for a in a_],
                              {k: self.encode(x) for k, x in kw.items()}]
                             for m, a_, kw in calls]
        return node


def _takes_device(cls_or_fn) -> bool:
    try:
        return "device" in inspect.signature(cls_or_fn).parameters
    except (TypeError, ValueError):
        return False


def _with_device(fn, args: list, kwargs: dict, device) -> Tuple[list, dict]:
    """``args`` and ``kwargs`` with ``device`` put in the place of any the
    call was given, and given where ``fn`` takes one."""
    if not _takes_device(fn):
        return args, kwargs
    names = [p.name for p in inspect.signature(fn).parameters.values()
             if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if "device" in names and names.index("device") < len(args):
        args = list(args)
        args[names.index("device")] = device
        return args, kwargs
    return args, {**kwargs, "device": device}


class _Decoder:
    def __init__(self, arrays: Dict[str, np.ndarray], schemas: List[dict], device):
        self.memo: Dict[int, Any] = {}
        self.arrays = arrays
        self.schemas: Dict[int, Any] = {}
        self._schema_dicts = schemas
        self.device = device

    def _array(self, node):
        if "__array__" in node:
            dtype = "int16" if node["dtype"] == "bfloat16" else node["dtype"]
            return np.asarray(node["__array__"], dtype=dtype).reshape(node["shape"])
        return self.arrays[node["__array_ref__"]]

    def schema(self, idx: int):
        from ..schema import Schema

        if idx not in self.schemas:
            self.schemas[idx] = Schema.from_dict(self._schema_dicts[idx])
        return self.schemas[idx]

    def decode(self, v) -> Any:
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if isinstance(v, list):
            return [self.decode(x) for x in v]
        if "__enum__" in v:
            return _import_class(v["__enum__"])(v["value"])
        if "__torch_dtype__" in v:
            return _TORCH_DTYPES[v["__torch_dtype__"]]
        if "__dtype__" in v:
            return np.dtype(v["__dtype__"])
        if "__device__" in v:
            return torch.device(v["__device__"])
        if "__tensor__" in v:
            node = v["__tensor__"]
            t = torch.from_numpy(np.array(self._array(node)))
            return t.view(torch.bfloat16) if node["dtype"] == "bfloat16" else t
        if "__array__" in v or "__array_ref__" in v:
            return np.array(self._array(v))
        if "__scalar__" in v:
            return self._array(v["__scalar__"])[()]
        if "__schema__" in v:
            return self.schema(v["__schema__"])
        if "__column__" in v:
            return self.schema(v["__column__"]["__schema__"]).first
        if "__tuple__" in v:
            return tuple(self.decode(x) for x in v["__tuple__"])
        if "__dict__" in v:
            return {k: self.decode(x) for k, x in v["__dict__"].items()}
        if "__ref__" in v:
            return self.memo[v["__ref__"]]
        if "__block__" in v:
            return self.block(v)
        if "__pickle__" in v:
            return pickle.loads(base64.b64decode(v["__pickle__"]))
        raise ConfigError(f"unknown config node: {sorted(v)}")

    def block(self, v):
        cls = _import_class(v["__block__"])
        args = [self.decode(a) for a in v["args"]]
        kwargs = {k: self.decode(a) for k, a in v["kwargs"].items()}
        args, kwargs = _with_device(cls, args, kwargs, self.device)
        obj = cls(*args, **kwargs)
        if "block_name" in v:
            obj.block_name = v["block_name"]
        if "schema" in v:
            obj.schema = self.schema(v["schema"]["__schema__"])
        if v.get("frozen"):
            obj._frozen = True
        for method, c_args, c_kwargs in v.get("calls", ()):
            fn = getattr(obj, method)
            c_args, c_kwargs = _with_device(fn, [self.decode(a) for a in c_args],
                                            {k: self.decode(x) for k, x in c_kwargs.items()},
                                            self.device)
            fn(*c_args, **c_kwargs)
        self.memo[v["id"]] = obj
        return obj


def to_config(block) -> Tuple[dict, Dict[str, np.ndarray]]:
    """(the config tree, its side arrays) of a block built from recorded
    constructor calls; raises :class:`ConfigError` where a part of it was
    not."""
    enc = _Encoder()
    tree = enc.encode(block)
    if not isinstance(tree, dict) or "__block__" not in tree:
        raise ConfigError(f"not a block with recorded constructor arguments: "
                          f"{type(block).__name__}")
    return {"root": tree, "schemas": enc.schemas}, enc.arrays


def from_config(config: dict, arrays: Optional[Dict[str, np.ndarray]] = None, device=None):
    """The block of :func:`to_config`'s tree, every constructor that takes a
    ``device`` given ``device``."""
    return _Decoder(arrays or {}, config["schemas"], device).decode(config["root"])
