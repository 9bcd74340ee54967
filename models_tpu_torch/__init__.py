"""models_tpu_torch: the PyTorch and CUDA port of models_tpu, for NVIDIA Hopper.

The JAX package ``models_tpu`` is the reference; this package imports nothing
of it, nor JAX. Entry points run on the card (``device="cuda"``, the default)
unless the caller passes ``device="cpu"``; without a card they raise.

The two-tower retrieval model is ported: build it from a schema, train it
(``compile(optimizer)``, ``fit``, with the top-k metrics and
``validation_data``) with the sampled-softmax loss on in-batch negatives, its
embedding tables optionally row-sparsely (``compile(embedding_optimizer=...)``)
and bf16 at rest (``TwoTowerModel(table_dtype=torch.bfloat16)``), evaluate it
in-batch or against the item corpus (``evaluate``), encode the catalog with
the candidate tower, index it fp32, bf16 or int8, and serve top-k. The CUDA
kernels (``csrc/``: the flash-CE forward and backward, streaming top-k, bin
rescoring, the row scatter-add and scatter-write, the row gather) are built
with ``nvcc`` at first use.
"""

from .blocks.optimizer import LazyAdam, SparseEmbeddingOptimizer
from .convert import load_jax_params
from .core import Encoder, SequenceFeature, TopKEncoder, TopKPrediction, resolve_device
from .core.policy import get_dtype_policy, set_dtype_policy
from .data import Dataset, Loader, generate_data
from .metrics import Metric, TopKMetricsAggregator
from .models import History, Model, RetrievalModelV2, TwoTowerModel
from .outputs import BruteForce, ContrastiveOutput, TopKOutput
from .schema import ColumnSchema, Schema, Tags

__all__ = [
    "BruteForce", "ColumnSchema", "ContrastiveOutput", "Dataset", "Encoder", "History",
    "LazyAdam", "Loader", "Metric", "Model",
    "RetrievalModelV2", "Schema", "SequenceFeature", "SparseEmbeddingOptimizer", "Tags",
    "TopKEncoder",
    "TopKMetricsAggregator", "TopKOutput", "TopKPrediction", "TwoTowerModel", "generate_data",
    "get_dtype_policy", "load_jax_params", "resolve_device", "set_dtype_policy",
]
