"""models_tpu_torch: the PyTorch and CUDA port of models_tpu, for NVIDIA Hopper.

The JAX package ``models_tpu`` is the reference; this package imports nothing
of it, nor JAX. Entry points run on the card (``device="cuda"``, the default)
unless the caller passes ``device="cpu"``; without a card they raise.

This slice serves the two-tower retrieval model: build it from a schema,
encode the catalog with the candidate tower, index it, and serve top-k. The
top-k kernels (``csrc/``) are built with ``nvcc`` at first use.
"""

from .convert import load_jax_params
from .core import Encoder, SequenceFeature, TopKEncoder, TopKPrediction, resolve_device
from .data import Dataset, Loader, generate_data
from .models import Model, RetrievalModelV2, TwoTowerModel
from .outputs import BruteForce, TopKOutput
from .schema import ColumnSchema, Schema, Tags

__all__ = [
    "BruteForce", "ColumnSchema", "Dataset", "Encoder", "Loader", "Model",
    "RetrievalModelV2", "Schema", "SequenceFeature", "Tags", "TopKEncoder",
    "TopKOutput", "TopKPrediction", "TwoTowerModel", "generate_data",
    "load_jax_params", "resolve_device",
]
