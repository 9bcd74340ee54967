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

    @property
    def dtype(self):
        return self.values.dtype

    def lengths(self) -> torch.Tensor:
        """(B,) int32: the valid positions of each row."""
        return self.mask.to(torch.int32).sum(dim=1, dtype=torch.int32)

    def with_values(self, values) -> "SequenceFeature":
        return SequenceFeature(values, self.mask)

    def with_mask(self, mask) -> "SequenceFeature":
        return SequenceFeature(self.values, mask)

    def masked(self, fill=0):
        """The values with padded positions replaced by ``fill``."""
        m = self.mask
        while m.ndim < self.values.ndim:
            m = m[..., None]
        return torch.where(m, self.values, torch.as_tensor(fill, dtype=self.values.dtype,
                                                             device=self.values.device))

    @classmethod
    def from_values_offsets(cls, values, offsets, max_len: int) -> "SequenceFeature":
        """On the host: a padded (B, max_len) numpy feature of ragged values
        and offsets."""
        values = np.asarray(values)
        offsets = np.asarray(offsets)
        batch = len(offsets) - 1
        out = np.zeros((batch, max_len) + values.shape[1:], dtype=values.dtype)
        mask = np.zeros((batch, max_len), dtype=bool)
        for i in range(batch):
            s, e = offsets[i], offsets[i + 1]
            n = min(e - s, max_len)
            out[i, :n] = values[s : s + n]
            mask[i, :n] = True
        return cls(out, mask)

    def __repr__(self):
        return f"SequenceFeature(values={tuple(self.values.shape)}, mask={tuple(self.mask.shape)})"


TensorLike = Union[torch.Tensor, SequenceFeature]
TensorDict = Dict[str, TensorLike]


class Prediction(NamedTuple):
    """Output of a model head. A head that computes its own loss (the fused
    contrastive loss) sets ``precomputed_loss``, with its weights folded in.
    ``label_relevant_counts`` (B,) is the number of relevant items per row
    where the targets were cut to the top k (the top-k head's evaluation)."""

    outputs: Any
    targets: Any = None
    sample_weight: Any = None
    negative_candidate_ids: Any = None
    label_relevant_counts: Any = None
    precomputed_loss: Any = None

    @property
    def predictions(self):
        return self.outputs


class TopKPrediction(NamedTuple):
    """Scores and ids from a top-k layer."""

    scores: torch.Tensor  # (B, k) f32
    identifiers: torch.Tensor  # (B, k) int32

    def with_k(self, k: int) -> "TopKPrediction":
        return TopKPrediction(self.scores[:, :k], self.identifiers[:, :k])

    def to_df(self):
        """A Dataset of per-row top-k list columns ``top_ids`` (int64) and
        ``top_scores`` (float32), copied to the host."""
        from ..data.dataset import Dataset

        return Dataset({
            "top_ids": list(np.asarray(self.identifiers.cpu(), dtype=np.int64)),
            "top_scores": list(np.asarray(self.scores.cpu(), dtype=np.float32)),
        })


# where a sequence transform leaves the positions to predict, (B, L) bool
MASK_KEY = "__sequence_prediction_mask__"


def prediction_mask_from_targets(targets):
    """The prediction mask of a :class:`SequenceFeature` target (the first
    one of a dict of targets), or None."""
    if isinstance(targets, SequenceFeature):
        return targets.mask
    if isinstance(targets, dict):
        for v in targets.values():
            if isinstance(v, SequenceFeature):
                return v.mask
    return None


class ModelContext(dict):
    """Shared context threaded through a forward pass: the raw ``features``,
    the batch's ``targets``, the global ``step`` and flags such as
    ``need_logits`` (False when nothing downstream reads a head's logits) and
    ``testing`` (set by ``evaluate``: heads take their evaluation branch).

    Made with :class:`SequenceFeature` targets, it holds their prediction
    mask under :data:`MASK_KEY` (the JAX package's recovery: a step builds a
    fresh context, and ``ReplaceMaskedEmbeddings`` reads the mask there)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if MASK_KEY not in self:
            m = prediction_mask_from_targets(self.get("targets"))
            if m is not None:
                self[MASK_KEY] = m

    @property
    def features(self) -> TensorDict:
        return self.get("features", {})

    @features.setter
    def features(self, value: TensorDict):
        self["features"] = value

    @property
    def targets(self):
        return self.get("targets")

    @targets.setter
    def targets(self, value):
        self["targets"] = value

    @property
    def mask(self):
        return self.get("mask")

    @mask.setter
    def mask(self, value):
        self["mask"] = value


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


def flatten_features(x: Dict[str, Any]) -> Dict[str, Any]:
    """A batch's features as a flat dict, each :class:`SequenceFeature` as
    ``<name>__values`` and ``<name>__mask`` (``models_tpu/utils/io.py``'s
    serving layout)."""
    flat = {}
    for name, v in x.items():
        if isinstance(v, SequenceFeature):
            flat[name + "__values"] = v.values
            flat[name + "__mask"] = v.mask
        else:
            flat[name] = v
    return flat


def unflatten_features(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flatten_features`."""
    out = {}
    for name, v in flat.items():
        if name.endswith("__values"):
            base = name[: -len("__values")]
            out[base] = SequenceFeature(v, flat[base + "__mask"])
        elif not name.endswith("__mask"):
            out[name] = v
    return out
