"""PyTorch side-backend (``models_tpu/torch_backend/``; reference
``merlin/models/torch/``, Lightning there).

Two layers, mirroring the reference:

- :mod:`.dsl` — the torch block DSL (Block/ParallelBlock/Residual/Shortcut,
  Batch, EmbeddingTable[s], TabularInputBlock, MLP/Cross/DLRM blocks,
  Binary/Regression/Categorical outputs, TabularOutputBlock, Model with a
  plain training loop, EncoderBlock batch prediction) — reference
  ``torch/block.py:42-670`` and siblings;
- :mod:`.models` — legacy compact monolithic models kept for back-compat.

Both consume the port's schema-driven Datasets and Loader. Every entry point
(the models' constructors, ``fit``, ``evaluate``, ``predict``, ``encode``,
``to_top_k_recommender``, ``evaluate_retrieval``, ``predict_next``) takes
``device=``, default the card, and raises without one unless given
``device="cpu"``. The two-tower model's index takes the port's exact top-k
(``ops/topk.py::topk_scores``: K5 and K6 on the card).
"""

from .models import TorchDCNModel, TorchDLRMModel, TorchMLPModel, TorchModel


def __getattr__(name):
    # torch imports are deferred: the DSL pulls in torch at import time, which
    # costs ~5s and isn't needed unless the torch backend is actually used
    import importlib

    dsl_names = {
        "Batch", "TorchSequence", "Block", "ParallelBlock", "ResidualBlock",
        "ShortcutBlock", "Concat", "Stack", "SelectKeys", "EmbeddingTable",
        "EmbeddingTables", "TabularInputBlock", "MLPBlock", "CrossBlock",
        "DLRMBlock", "ModelOutput", "BinaryOutput", "RegressionOutput",
        "CategoricalOutput", "TabularOutputBlock", "Model", "EncoderBlock",
        "DLRMModel", "DCNModel", "MLPModel", "MMOEBlock", "CGCBlock",
        "PLEBlock", "CrossAttentionBlock",
    }
    compat_names = {
        "Sequence", "repeat", "repeat_parallel", "repeat_parallel_like",
        "BatchBlock", "RouterBlock", "SelectFeatures", "CategoricalTarget",
        "EmbeddingTablePrediction", "TabularPadding", "BroadcastToSequence",
        "stack_context", "walk", "map", "MultiLoader", "DaskEncoder",
        "DaskPredictor",
    }
    tracing_names = {
        "trace", "select", "extract", "select_schema", "select_union",
        "selection_name", "Selectable", "input_schema", "output_schema",
        "feature_schema", "target_schema",
    }
    retrieval_names = {
        "ContrastiveOutput", "InBatchNegativeSampler", "PopularityBasedSampler",
        "LogUniformSampler", "BruteForceIndex", "RetrievalModel",
        "TopKRecommender", "TwoTowerModel",
    }
    sequence_names = {
        "TabularSequenceTransform", "TabularPredictNext", "TabularPredictLast",
        "TabularMaskRandom", "TabularMaskLast", "NextItemOutput",
        "SessionTransformerModel",
    }
    if name == "dsl":
        return importlib.import_module(".dsl", __name__)
    if name == "retrieval":
        return importlib.import_module(".retrieval", __name__)
    if name == "sequences":
        return importlib.import_module(".sequences", __name__)
    if name in sequence_names:
        return getattr(importlib.import_module(".sequences", __name__), name)
    if name == "compat":
        return importlib.import_module(".compat", __name__)
    if name == "schema" or name == "tracing":
        # the reference exposes its trace/select machinery as the ``schema``
        # submodule (merlin/models/torch/schema.py) — ours lives in tracing.py
        return importlib.import_module(".tracing", __name__)
    if name in tracing_names:
        return getattr(importlib.import_module(".tracing", __name__), name)
    if name in dsl_names:
        return getattr(importlib.import_module(".dsl", __name__), name)
    if name in retrieval_names:
        return getattr(importlib.import_module(".retrieval", __name__), name)
    if name in compat_names:
        return getattr(importlib.import_module(".compat", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["TorchModel", "TorchDLRMModel", "TorchDCNModel", "TorchMLPModel", "dsl"]
