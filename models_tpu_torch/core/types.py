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
    """Output of a model head. A head that computes its own loss (the fused
    contrastive loss) sets ``precomputed_loss``, with its weights folded in."""

    outputs: Any
    targets: Any = None
    sample_weight: Any = None
    precomputed_loss: Any = None
    negative_candidate_ids: Any = None


class TopKPrediction(NamedTuple):
    """Scores and ids from a top-k layer."""

    scores: torch.Tensor  # (B, k) f32
    identifiers: torch.Tensor  # (B, k) int32


class ModelContext(dict):
    """Shared context threaded through a forward pass: the raw ``features``,
    the batch's ``targets``, the global ``step`` and flags such as
    ``need_logits`` (False when nothing downstream reads a head's logits)."""

    @property
    def features(self) -> TensorDict:
        return self.get("features", {})


def _to_device(val, device):
    if isinstance(val, SequenceFeature):
        return SequenceFeature(
            torch.as_tensor(np.asarray(val.values), device=device),
            torch.as_tensor(np.asarray(val.mask), device=device),
        )
    return torch.as_tensor(np.asarray(val), device=device)


def to_device_batch(host_batch: Dict[str, Any], device) -> TensorDict:
    """numpy host batch -> tensors on ``device`` (SequenceFeature kept)."""
    return {name: _to_device(val, device) for name, val in host_batch.items()}


def to_device_targets(targets, device):
    """The loader's targets (None, one array, or a dict of them) on ``device``."""
    if targets is None:
        return None
    if isinstance(targets, dict):
        return to_device_batch(targets, device)
    return _to_device(targets, device)
