"""Carry a JAX model's parameters over to its port.

The caller flattens the JAX side: ``{"/".join(path): numpy array}`` over
``nnx.state(model, nnx.Param)``. The port's module tree mirrors the JAX
attribute names, so a key maps to the parameter of the same dotted path,
except that a Dense ``kernel`` (in, out) becomes the port's ``weight``
(out, in). Embedding tables are copied whole, padding rows included. The
top-k index is not carried: the port rebuilds it from its own candidate tower.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_jax_params(module: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy ``flat`` into ``module``'s parameters. Raises on a key that names
    no parameter, on a shape mismatch, and on any parameter left unset."""
    params = dict(module.named_parameters())
    unset = set(params)
    for key, value in flat.items():
        parts = key.split("/")
        arr = np.asarray(value, dtype=np.float32)  # bf16 arrays widen exactly
        if parts[-1] == "kernel":
            parts, arr = parts[:-1] + ["weight"], arr.T
        name = ".".join(parts)
        if name not in params:
            raise KeyError(f"JAX parameter {key!r} has no counterpart {name!r} in the port")
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{key!r}: JAX shape {arr.shape} != port shape {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(arr, dtype=p.dtype))
        unset.discard(name)
    if unset:
        raise ValueError(f"port parameters left unset: {sorted(unset)}")
    return module
