"""models_tpu_torch: the PyTorch and CUDA port of models_tpu, for NVIDIA Hopper.

The JAX package ``models_tpu`` is the reference; this package imports nothing
of it, nor JAX. Entry points run on the card (``device="cuda"``, the default)
unless the caller passes ``device="cpu"``; without a card they raise.

The two-tower retrieval model is ported: build it from a schema, train it
(``compile(optimizer, metrics=[])``, ``fit``) with the sampled-softmax loss on
in-batch negatives, encode the catalog with the candidate tower, index it,
and serve top-k. The CUDA kernels (``csrc/``: the flash-CE forward and
backward, streaming top-k, bin rescoring) are built with ``nvcc`` at first use.
"""

from .convert import load_jax_params
from .core import Encoder, SequenceFeature, TopKEncoder, TopKPrediction, resolve_device
from .data import Dataset, Loader, generate_data
from .models import History, Model, RetrievalModelV2, TwoTowerModel
from .outputs import BruteForce, ContrastiveOutput, TopKOutput
from .schema import ColumnSchema, Schema, Tags

__all__ = [
    "BruteForce", "ColumnSchema", "ContrastiveOutput", "Dataset", "Encoder", "History",
    "Loader", "Model",
    "RetrievalModelV2", "Schema", "SequenceFeature", "Tags", "TopKEncoder",
    "TopKOutput", "TopKPrediction", "TwoTowerModel", "generate_data",
    "load_jax_params", "resolve_device",
]
