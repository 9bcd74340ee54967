"""Value types flowing through the port's models (``models_tpu/core/types.py``)."""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Union

import numpy as np
import torch


class SequenceFeature:
    """A padded list feature: ``values`` (B, L, ...) and boolean ``mask`` (B, L)."""

    __slots__ = ("values", "mask")

    def __init__(self, values, mask=None):
        self.values = values
        if mask is None:
            mask = torch.ones(values.shape[:2], dtype=torch.bool, device=values.device)
        self.mask = mask

    @property
    def shape(self):
        return self.values.shape

    def __repr__(self):
        return f"SequenceFeature(values={tuple(self.values.shape)}, mask={tuple(self.mask.shape)})"


TensorLike = Union[torch.Tensor, SequenceFeature]
TensorDict = Dict[str, TensorLike]


class Prediction(NamedTuple):
    """Output of a model head (the fields the serving path reads)."""

    outputs: Any
    targets: Any = None


class TopKPrediction(NamedTuple):
    """Scores and ids from a top-k layer."""

    scores: torch.Tensor  # (B, k) f32
    identifiers: torch.Tensor  # (B, k) int32


class ModelContext(dict):
    """Shared context threaded through a forward pass (raw features, flags)."""

    @property
    def features(self) -> TensorDict:
        return self.get("features", {})


def to_device_batch(host_batch: Dict[str, Any], device) -> TensorDict:
    """numpy host batch -> tensors on ``device`` (SequenceFeature kept)."""
    out: TensorDict = {}
    for name, val in host_batch.items():
        if isinstance(val, SequenceFeature):
            out[name] = SequenceFeature(
                torch.as_tensor(np.asarray(val.values), device=device),
                torch.as_tensor(np.asarray(val.mask), device=device),
            )
        else:
            out[name] = torch.as_tensor(np.asarray(val), device=device)
    return out
