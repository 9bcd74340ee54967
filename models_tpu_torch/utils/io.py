"""Saving, loading and serving export (``models_tpu/utils/io.py``).

:func:`save_model` writes a directory:

- ``config.json``: the format, the constructor-replay tree of
  ``core/config.py`` (``config``), the shapes and dtypes of the batch the
  model built its lazy layers on (``build_spec``), and which state arrays
  are bf16 (``bfloat16``);
- ``state.npz``: the model's state by its ``state_dict()`` names (each
  tensor once: a tied table under its first name), the parameters and the
  persistent buffers (row-sparse slots, BatchNorm statistics, a cross-batch
  queue's ring, dynamic tables' keys, a top-k index), bf16 ones as their
  bit patterns, and the config's side arrays;
- ``.merlin/input_schema.json`` and ``output_schema.json``: the schema in the
  TF-metadata JSON layout, byte-equal to the JAX package's.

:func:`load_model` replays the constructors on its ``device`` (never the
saved one), builds the lazy layers on zeros of the build batch's shapes,
makes the tensors the file holds and a fresh model has not yet (row-sparse
slots, an index's buffers) and copies every array in; no module is
unpickled. ``format="pickle"`` saves the module with ``torch.save`` instead
(``model.pt``), the engine's attributes (the optimizer, captured graphs)
set aside, for blocks the config cannot express.

:func:`export_serving` traces the inference step with ``torch.export``:
one program a platform (``serving_cuda.pt2``, ``serving_cpu.pt2``), each
holding the graph, the weights and the top-k index, and calling the K5 and
K6 kernels as the ``models_tpu_torch::`` custom ops. :class:`ServingModel`
runs a program with no model class, config or constructor: it needs
``import models_tpu_torch``, which registers the ops.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
from typing import Any, Dict

import numpy as np
import torch

from ..core.device import check_module_device, resolve_device
from ..core.types import flatten_features, unflatten_features

SIDECAR_DIR = ".merlin"
CONFIG_FILE = "config.json"
STATE_FILE = "state.npz"
MODEL_FILE = "model.pt"
SERVING_SPEC = "serving_spec.json"

# engine attributes that hold the optimizer, captured graphs, staged batches
# and the compiled specs: set aside by the pickle format and the CPU copy of
# an export, remade by compile()
ENGINE_ATTRS = ("_optimizer", "_chunk_graphs", "_group_graphs", "_eval_graphs", "_pre_transform",
                "_host_stage", "_emb_opt", "_sparse_tables", "_frozen_ids", "_loss_spec",
                "_metrics_spec", "_optimizer_spec", "_learning_rate", "_head_weights", "history",
                "_compiled", "_mesh", "_fit_mesh_fp")


@contextlib.contextmanager
def engine_set_aside(model):
    """``model`` without its engine's attributes (:data:`ENGINE_ATTRS`: the
    optimizer and its slots, captured CUDA graphs, which cannot be copied
    or pickled, the compiled specs) inside the block; they are put back
    after it."""
    saved = {a: model.__dict__.pop(a) for a in ENGINE_ATTRS if a in model.__dict__}
    try:
        yield model
    finally:
        model.__dict__.update(saved)


def cpu_copy(model):
    """A copy of ``model`` on the CPU, not compiled: its parameters and
    buffers copied straight to the host (no second copy on the card), its
    engine left behind (:func:`engine_set_aside`)."""
    memo = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        host = t.detach().to("cpu", copy=True)
        memo[id(t)] = (torch.nn.Parameter(host, requires_grad=t.requires_grad)
                       if isinstance(t, torch.nn.Parameter) else host)
    with engine_set_aside(model):
        return copy.deepcopy(model, memo).to("cpu")


@contextlib.contextmanager
def _placement_set_aside(model):
    """``model`` with its mesh placement (the tables' shards, the modules'
    records of sharded tensors, a split index's mesh) taken off inside the
    block and put back after it: a mesh's process groups cannot be copied."""
    saved = []
    for m in model.modules():
        for key in ("_mesh_specs", "_mesh_of_state", "mesh", "shard"):
            if key in m.__dict__:
                saved.append((m, key, m.__dict__.pop(key)))
                if key in ("mesh", "shard"):
                    m.__dict__[key] = None
    try:
        yield model
    finally:
        for m, key, value in saved:
            m.__dict__[key] = value


def whole_copy(model, device=None):
    """A model placed on a mesh as one whole model: a copy (its engine left
    behind, on ``device``, default the model's own) whose sharded tensors
    are gathered whole. A collective: every rank of the mesh calls it."""
    from ..parallel.mesh import named_tensors, full_state, sharded_names

    specs = sharded_names(model)
    state = full_state(model, model_state(model))
    with _placement_set_aside(model):
        copied = cpu_copy(model)
    tensors = named_tensors(copied)
    with torch.no_grad():
        for name in specs:
            tensors[name].data = state[name].detach().cpu().clone()
    dev = device if device is not None else next(
        (t.device for t in itertools.chain(model.parameters(), model.buffers())), None)
    return copied.to(dev) if dev is not None else copied


def serving_file(platform: str) -> str:
    return f"serving_{platform}.pt2"


# ---------------------------------------------------------------------------
# the build batch's shapes, replayed at load
# ---------------------------------------------------------------------------

def spec_of(v) -> Any:
    from ..core.types import SequenceFeature

    if v is None:
        return None
    if isinstance(v, SequenceFeature):
        return {"__seq__": [spec_of(v.values), spec_of(v.mask)]}
    if isinstance(v, dict):
        return {"__dict__": {k: spec_of(x) for k, x in v.items()}}
    if isinstance(v, tuple):
        return {"__tuple__": [spec_of(x) for x in v]}
    arr = np.asarray(v.cpu() if torch.is_tensor(v) else v)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def zeros_from_spec(spec) -> Any:
    """Host arrays of the spec's shapes: zeros, booleans (masks, row
    validity) all True."""
    from ..core.types import SequenceFeature

    if spec is None:
        return None
    if "__seq__" in spec:
        vals, mask = spec["__seq__"]
        return SequenceFeature(zeros_from_spec(vals), zeros_from_spec(mask))
    if "__dict__" in spec:
        return {k: zeros_from_spec(x) for k, x in spec["__dict__"].items()}
    if "__tuple__" in spec:
        return tuple(zeros_from_spec(x) for x in spec["__tuple__"])
    dtype = np.dtype(spec["dtype"])
    if dtype.kind == "b":
        return np.ones(spec["shape"], dtype=dtype)
    return np.zeros(spec["shape"], dtype=dtype)


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def model_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict()`` (parameters and persistent buffers,
    detached), each tensor once, under its first name."""
    out: Dict[str, torch.Tensor] = {}
    seen = set()
    for key, t in model.state_dict(keep_vars=True).items():
        if not torch.is_tensor(t) or id(t) in seen:
            continue
        seen.add(id(t))
        out[key] = t.detach()
    return out


def state_to_numpy(state: Dict[str, torch.Tensor]):
    """(arrays, bf16 names): bf16 tensors as their 16-bit patterns."""
    arrays, bf16 = {}, []
    for key, t in state.items():
        t = t.cpu()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            t = t.view(torch.int16)
        arrays[key] = t.numpy()
    return arrays, bf16


def _make_missing(model: torch.nn.Module, state: Dict[str, torch.Tensor], dev) -> None:
    """Make the tensors that ``state`` holds and ``model`` has not yet: a
    table's row-sparse slots (``<table>.sparse_slots.<name>``) and buffers
    registered empty (a top-k index before ``index()``)."""
    from ..inputs.embedding import SparseSlots

    have = model.state_dict(keep_vars=True)
    slots: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in state.items():
        if key in have:
            continue
        prefix, name = key.rsplit(".", 1) if "." in key else ("", key)
        if prefix == "sparse_slots" or prefix.endswith(".sparse_slots"):
            owner = prefix[: -len("sparse_slots")].rstrip(".")
            slots.setdefault(owner, {})[name] = torch.empty(value.shape, dtype=value.dtype,
                                                            device=dev)
            continue
        mod = model.get_submodule(prefix)
        if name in mod._buffers and mod._buffers[name] is None:
            mod._buffers[name] = torch.empty(value.shape, dtype=value.dtype, device=dev)
        else:
            raise KeyError(f"the saved state holds {key!r}, which the model does not have")
    for owner, tensors in slots.items():
        model.get_submodule(owner).sparse_slots = SparseSlots(tensors)


@torch.no_grad()
def load_state(model: torch.nn.Module, state: Dict[str, torch.Tensor], dev) -> None:
    """Copy ``state`` (tensors by ``state_dict()`` name, each once) into
    ``model`` in place, each tensor keeping its dtype and address; makes
    the row-sparse slots and empty buffers the model lacks first. Raises
    where a name of either side is missing on the other or a shape
    differs."""
    _make_missing(model, state, dev)
    full = model.state_dict(keep_vars=True)
    alias: Dict[int, str] = {}
    for key, t in full.items():
        if torch.is_tensor(t):
            alias.setdefault(id(t), key)
    for key, t in full.items():
        if not torch.is_tensor(t) or alias[id(t)] != key:
            continue
        if key not in state:
            raise KeyError(f"the saved state has no {key!r}")
        value = state[key]
        if tuple(value.shape) != tuple(t.shape):
            raise ValueError(f"{key}: saved shape {tuple(value.shape)}, the model's "
                             f"{tuple(t.shape)}")
        t.copy_(value.to(t.device))
    # blocks that keep host values beside their buffers (a top-k index's
    # row count) read them back
    for m in model.modules():
        hook = getattr(m, "state_loaded", None)
        if hook is not None:
            hook()


def _numpy_to_state(arrays: Dict[str, np.ndarray], bf16) -> Dict[str, torch.Tensor]:
    out = {}
    for key, a in arrays.items():
        t = torch.from_numpy(np.array(a))
        out[key] = t.view(torch.bfloat16) if key in bf16 else t
    return out


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------

def _write_sidecar(model, path: str) -> None:
    schema = getattr(model, "schema", None)
    if schema is None:
        return
    sidecar = os.path.join(path, SIDECAR_DIR)
    os.makedirs(sidecar, exist_ok=True)
    schema.save(os.path.join(sidecar, "input_schema.json"))
    if len(schema.targets):
        schema.targets.save(os.path.join(sidecar, "output_schema.json"))


def save_model(model, path: str, format: str = "auto") -> str:
    """Save ``model`` to the directory ``path``. ``format``: ``"config"``
    (the constructor replay; raises where the config cannot express the
    model), ``"pickle"`` (``torch.save`` of the module), or ``"auto"`` (the
    config, else the pickle, with a warning)."""
    import warnings

    from ..core.config import ConfigError

    from ..parallel.mesh import barrier, is_chief, state_mesh

    if format not in ("auto", "config", "pickle"):
        raise ValueError(f"format must be 'auto', 'config' or 'pickle', not {format!r}")
    if state_mesh(model) is not None:
        # a model on a mesh: made whole through the host, written by the chief
        whole = whole_copy(model, "cpu")
        if is_chief():
            save_model(whole, path, format=format)
        barrier()
        return path
    os.makedirs(path, exist_ok=True)
    if format in ("auto", "config"):
        try:
            _save_config(model, path)
        except ConfigError as err:
            if format == "config":
                raise
            warnings.warn(f"the config cannot express the model ({err}); saving the pickled "
                          "module instead", stacklevel=2)
        else:
            if os.path.exists(os.path.join(path, MODEL_FILE)):
                os.remove(os.path.join(path, MODEL_FILE))
            _write_sidecar(model, path)
            return path
    _save_pickle(model, path)
    _write_sidecar(model, path)
    return path


def _save_config(model, path: str) -> None:
    from ..core.config import to_config

    tree, cfg_arrays = to_config(model)
    arrays, bf16 = state_to_numpy(model_state(model))
    clash = set(arrays) & set(cfg_arrays)
    if clash:
        raise ValueError(f"state and config array names clash: {sorted(clash)}")
    arrays.update(cfg_arrays)
    doc = {"format": "config", "config": tree,
           "build_spec": getattr(model, "_build_spec", None), "bfloat16": bf16}
    text = json.dumps(doc)  # before any file is written: a failure leaves none
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        f.write(text)
    np.savez(os.path.join(path, STATE_FILE), **arrays)


def _save_pickle(model, path: str) -> None:
    with engine_set_aside(model):
        torch.save(model, os.path.join(path, MODEL_FILE))
    for stale in (CONFIG_FILE, STATE_FILE):
        if os.path.exists(os.path.join(path, stale)):
            os.remove(os.path.join(path, stale))


def load_model(path: str, device=None):
    """The model saved at ``path``, on ``device`` (default the card; raises
    without one unless given ``"cpu"``), not compiled."""
    dev = resolve_device(device)
    cfg_path = os.path.join(path, CONFIG_FILE)
    if not os.path.exists(cfg_path):
        model = torch.load(os.path.join(path, MODEL_FILE), map_location=dev, weights_only=False)
        return model.to(dev)
    from ..core.config import from_config

    with open(cfg_path) as f:
        doc = json.load(f)
    with np.load(os.path.join(path, STATE_FILE)) as z:
        arrays = {k: z[k] for k in z.files}
    cfg_arrays = {k: v for k, v in arrays.items() if k.startswith("cfg_arr_")}
    model = from_config(doc["config"], cfg_arrays, device=dev)
    model.to(dev)
    spec = doc.get("build_spec")
    if spec is not None:
        model.build(zeros_from_spec(spec), device=dev)
    state = _numpy_to_state({k: v for k, v in arrays.items() if k not in cfg_arrays},
                            set(doc.get("bfloat16", ())))
    load_state(model, state, dev)
    return model


# ---------------------------------------------------------------------------
# serving export
# ---------------------------------------------------------------------------

class _Serve(torch.nn.Module):
    """The inference step on flat features: what ``predict`` returns of the
    model's output for a batch."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, feats: Dict[str, torch.Tensor]):
        from ..core.types import ModelContext

        x = unflatten_features(feats)
        preds = self.model(x, training=False, context=ModelContext(features=x))
        return self.model._outputs(preds)


def _sample_features(model, data, batch_size: int, dev):
    from ..data.dataset import Dataset
    from ..data.loader import ROW_VALID_KEY, Loader

    if data is None:
        raise ValueError("export_serving needs sample data (a Dataset, a Loader or a dict)")
    if isinstance(data, dict):
        x = data
        model.build((x, None), device=dev)
    else:
        loader = data if isinstance(data, Loader) else Loader(
            Dataset(data), batch_size=batch_size, shuffle=False, drop_last=True)
        x, _ = next(iter(loader))
        model.build(loader, device=dev)
    return {k: v for k, v in x.items() if k != ROW_VALID_KEY}


def export_serving(model, path: str, data=None, batch_size: int = 1024, platforms=None,
                   device=None) -> str:
    """Export the inference step of ``model`` (on ``device``, default the
    card) as programs that run with no model code:

    - ``serving_<platform>.pt2``: ``torch.export`` of the step for each of
      ``platforms`` (default the model's device and ``"cpu"``; the CPU
      program is traced on a CPU copy without the engine, :func:`cpu_copy`),
      with the weights and the index;
    - ``serving_spec.json``: each flat feature's shape and dtype (a list
      feature as ``<name>__values`` and ``<name>__mask``), the batch size
      and the platforms;
    - the ``.merlin/`` schema sidecars.

    The batch size is static: the sample batch's (``data``: a Dataset or
    Loader, of which the first full batch of ``batch_size`` rows, or a dict
    of host arrays). A model with a dynamic-vocabulary table does not
    export (its lookup inserts keys). A model on a mesh is made whole
    (:func:`whole_copy`: every rank calls this) and the chief writes."""
    from ..parallel.mesh import barrier, is_chief, state_mesh

    dev = check_module_device(model, device)
    if state_mesh(model) is not None:
        whole = whole_copy(model, dev)
        if is_chief():
            export_serving(whole, path, data=data, batch_size=batch_size, platforms=platforms,
                           device=dev)
        barrier()
        return path
    os.makedirs(path, exist_ok=True)
    x = _sample_features(model, data, batch_size, dev)
    flat = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
            for k, v in flatten_features(x).items()}
    if platforms is None:
        platforms = tuple(dict.fromkeys((dev.type, "cpu")))
    for plat in platforms:
        if plat not in ("cuda", "cpu"):
            raise ValueError(f"platforms are 'cuda' and 'cpu', not {plat!r}")
        if plat == "cuda" and dev.type != "cuda":
            raise ValueError("a CUDA program is traced from a model on the card")
        target = model if plat == dev.type else cpu_copy(model)
        feats = {k: torch.as_tensor(v, device=dev if plat == dev.type else plat)
                 for k, v in flat.items()}
        was_training = target.training
        target.eval()
        try:
            # one eager call first: caches a block fills at its first call (a
            # DLRM interaction's triangle indices) hold real tensors, which
            # the trace takes as constants
            with torch.no_grad():
                _Serve(target)(feats)
            program = torch.export.export(_Serve(target), (feats,), strict=False)
        finally:
            target.train(was_training)
        torch.export.save(program, os.path.join(path, serving_file(plat)))
        del target
    spec = {
        "features": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
        "batch_size": int(next(iter(flat.values())).shape[0]),
        "platforms": list(platforms),
    }
    with open(os.path.join(path, SERVING_SPEC), "w") as f:
        json.dump(spec, f, indent=1)
    _write_sidecar(model, path)
    return path


class ServingModel:
    """A serving artifact loaded on ``device`` (default the card; raises
    without one unless given ``"cpu"``): ``ServingModel(path)(features)``,
    features flat or with :class:`SequenceFeature` values, host arrays or
    tensors, gives what the model's ``predict`` gives for the batch (the
    head's activation, ``{"scores", "ids"}`` for a top-k model, or a dict by
    head), as tensors on the device."""

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(path, SERVING_SPEC)) as f:
            self.spec = json.load(f)
        file = os.path.join(path, serving_file(self.device.type))
        if not os.path.exists(file):
            raise FileNotFoundError(f"{path} holds no program for {self.device.type} (platforms "
                                    f"{self.spec['platforms']})")
        self.program = torch.export.load(file)
        self._run = self.program.module()

    def __call__(self, features: Dict[str, Any]):
        flat = flatten_features({k: v for k, v in features.items() if not k.startswith("__")})
        missing = set(self.spec["features"]) - set(flat)
        if missing:
            raise KeyError(f"features missing from the request: {sorted(missing)}")
        feats = {}  # each feature checked against the spec, by name
        for name, want in self.spec["features"].items():
            t = torch.as_tensor(flat[name])
            if list(t.shape) != want["shape"] or str(t.dtype).split(".")[-1] != want["dtype"]:
                raise ValueError(f"feature {name!r}: {tuple(t.shape)} {t.dtype}, the program "
                                 f"takes {tuple(want['shape'])} {want['dtype']}")
            feats[name] = t.to(self.device)
        with torch.no_grad():
            return self._run(feats)


def load_serving(path: str, device=None) -> ServingModel:
    return ServingModel(path, device=device)
