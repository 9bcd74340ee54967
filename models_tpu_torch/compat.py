"""The reference namespace's other names (``models_tpu/compat.py``): every
public name of ``merlin.models.tf`` that maps onto a construct of the port
under another (usually V2-era) name, and the small V1 config classes.

``ToDense``, ``ToSparse``, ``ToOneHot`` and ``TensorInitializer`` compute
in torch; the aliases name the port's own blocks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .core.aggregation import (  # noqa: F401  (same names as the reference)
    ConcatFeatures,
    ElementwiseSum,
    ElementwiseSumItemMulti,
    StackFeatures,
)
from .core.block import Block
from .core.combinators import ParallelBlock
from .core.types import SequenceFeature
from .registry import aggregation_registry


def SequenceAggregator(combiner: str = "mean"):
    """Reference ``SequenceAggregator(combiner)`` → the registered
    ``sequence-<combiner>`` aggregation."""
    return aggregation_registry.parse(f"sequence-{combiner}")


# ---- V1 alias names --------------------------------------------------------

from .inputs.continuous import Continuous as ContinuousFeatures  # noqa: F401,E402
from .outputs.sampling import (  # noqa: F401,E402
    CandidateSampler as ItemSampler,
    InBatchSampler as InBatchSamplerV2,
    PopularityBasedSampler as PopularityBasedSamplerV2,
)
from .outputs.base import ModelOutput as PredictionTask  # noqa: F401,E402
from .outputs.topk import BruteForce as IndexBlock  # noqa: F401,E402
from .outputs.topk import BruteForce as TopKIndexBlock  # noqa: F401,E402
from .metrics.base import LogLoss as LogLossMetric  # noqa: F401,E402
from .transforms.features import PrepareFeatures as PrepareListFeatures  # noqa: F401,E402
from .models.retrieval import RetrievalModelV2 as RetrievalModel  # noqa: F401,E402
from .models.retrieval import (  # noqa: F401,E402
    YoutubeDNNRetrievalModel as YoutubeDNNRetrievalModelV2,
)
from .blocks.retrieval import QueryItemIdsEmbeddingsBlock  # noqa: F401,E402

from .outputs.tasks import ParallelPredictionBlock  # noqa: F401,E402

TabularBlock = ParallelBlock  # dict-in/dict-out block with pre/post/aggregation


def right_shift_layer(right, left):
    """The ``>>`` composition helper: a list, str or Tags left operand
    becomes a Filter selection (the reference's ``['col'] >> block``)."""
    from .core.block import as_block
    from .core.combinators import Filter, SequentialBlock
    from .schema import Tags

    if isinstance(left, (list, tuple, str, Tags)) and not isinstance(left, Block):
        left = Filter(left)
    return SequentialBlock([as_block(left), as_block(right)])


def is_transformers_available() -> bool:
    """The session transformer stack is the port's own (no HF dependency):
    always available."""
    return True


# ---- small V1 config classes -----------------------------------------------

class EmbeddingWithMetadata(NamedTuple):
    """Embeddings and their metadata."""

    embeddings: torch.Tensor
    metadata: dict


@dataclass
class TableConfig:
    """V1 table config (reference ``tf/inputs/embedding.py:25``)."""

    vocabulary_size: int
    dim: int
    initializer: Optional[Callable] = None
    combiner: Optional[str] = "mean"
    name: Optional[str] = None


@dataclass
class FeatureConfig:
    table: TableConfig
    max_sequence_length: int = 0
    name: Optional[str] = None


@dataclass
class EmbeddingOptions:
    """V1 embedding options (reference ``tf/inputs/embedding.py:932``),
    convertible to ``Embeddings()`` keyword arguments."""

    embedding_dims: Optional[dict] = None
    embedding_dim_default: Optional[int] = 64
    infer_embedding_sizes: bool = False
    infer_embedding_sizes_multiplier: float = 2.0
    embeddings_l2_reg: float = 0.0

    def to_kwargs(self) -> dict:
        dim: Union[int, dict, None]
        if self.infer_embedding_sizes:
            dim = self.embedding_dims  # per-name overrides; the rest inferred
        elif self.embedding_dims:
            # unlisted columns get embedding_dim_default, not inference
            dim = _DimDict(self.embedding_dims, self.embedding_dim_default or 64)
        else:
            dim = self.embedding_dim_default
        return {
            "dim": dim,
            "infer_dim_multiplier": self.infer_embedding_sizes_multiplier,
            "l2_reg": self.embeddings_l2_reg,
        }


class _DimDict(dict):
    """Per-name dims with a default for unlisted names (EmbeddingOptions)."""

    def __init__(self, base, default):
        super().__init__(base)
        self.default = int(default)

    def __contains__(self, key):
        return True

    def __missing__(self, key):
        return self.default


class TensorInitializer:
    """An initializer that returns a fixed array, as
    ``EmbeddingTable(initializer=TensorInitializer(arr))`` calls it
    (``(generator, shape, device)``). The one shape difference allowed is
    the table's padding of its rows to a multiple of 8."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, generator, shape, device=None):
        arr = torch.as_tensor(self.value, dtype=torch.float32, device=device)
        if tuple(shape) == tuple(arr.shape):
            return arr.clone()
        if (
            arr.ndim != len(shape)
            or tuple(arr.shape[1:]) != tuple(shape[1:])
            or arr.shape[0] > shape[0]
            or shape[0] - arr.shape[0] >= 8
        ):
            raise ValueError(
                f"TensorInitializer value shape {tuple(arr.shape)} does not match "
                f"table shape {tuple(shape)} (only multiple-of-8 row padding differs)"
            )
        out = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        out[: arr.shape[0]] = arr
        return out


# ---- ToDense / ToSparse / ToOneHot -----------------------------------------

class ToDense(Block):
    """SequenceFeatures → their padded values (the mask dropped)."""

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, SequenceFeature):
            return inputs.values
        if isinstance(inputs, dict):
            return {
                k: v.values if isinstance(v, SequenceFeature) else v
                for k, v in inputs.items()
            }
        return inputs


class ToSparse(Block):
    """Identity: :class:`SequenceFeature` (padded values and a mask) is the
    one list encoding; there is no sparse type to convert to."""

    def forward(self, inputs, **kwargs):
        return inputs


class ToOneHot(Block):
    """Integer targets or features → one-hot float32 of ``num_classes``."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = int(num_classes)

    def _one(self, v):
        return F.one_hot(torch.as_tensor(v).long(), self.num_classes).to(torch.float32)

    def forward(self, inputs, **kwargs):
        if isinstance(inputs, dict):
            return {k: self._one(v) for k, v in inputs.items()}
        return self._one(inputs)
