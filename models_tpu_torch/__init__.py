"""models_tpu_torch: the PyTorch and CUDA port of models_tpu, for NVIDIA Hopper.

The JAX package ``models_tpu`` is the reference; this package imports nothing
of it, nor JAX. Entry points run on the card (``device="cuda"``, the default)
unless the caller passes ``device="cpu"``; without a card they raise.

The block DSL (``>>``, ``SequentialBlock``, ``ParallelBlock`` with named
aggregations, ``Filter``, ``ResidualBlock``, ...; layers whose widths build
at the model's build pass), the rest of the inputs (pretrained and frozen
tables, dynamic-vocabulary and tensor-train tables), the feature transforms
and Wide&Deep are ported. The multi-task models (``MMOEModel``, ``PLEModel``, the V1
``PredictionTasks``), trained with loss and class weights, adam, adamw,
adagrad, rmsprop, lamb, adafactor or sgd (or a ``MultiOptimizer``), frozen
blocks and callbacks, are ported. The retrieval models (the two-tower model, the matrix factorization and
YouTube-DNN, with in-batch, cross-batch and popularity-sampled negatives,
the pairwise losses and the beyond-accuracy metrics), the ranking models (DLRM, DCN-v2, DeepFM,
NCF) and the session models (``SessionBasedTransformerModel`` over the
transformer blocks of ``transformer/``, trained with the sequence transforms
of ``transforms/sequence.py`` as ``fit(pre=...)``) are ported. Build the two-tower model from a schema, train it
(``compile(optimizer)``, ``fit``, with the top-k metrics and
``validation_data``) with the sampled-softmax loss on in-batch negatives, its
embedding tables optionally row-sparsely (``compile(embedding_optimizer=...)``)
and bf16 at rest (``TwoTowerModel(table_dtype=torch.bfloat16)``), evaluate it
in-batch or against the item corpus (``evaluate``), encode the catalog with
the candidate tower, index it fp32, bf16 or int8, and serve top-k. Build a
ranking model from a schema with TARGET columns (its heads: binary,
regression, categorical), train it (dense or row-sparse, one step at a time
or k steps a CUDA graph replay), evaluate it (AUC, precision, recall, binary
accuracy; RMSE) and ``predict`` probabilities. The CUDA
kernels (``csrc/``: the flash-CE forward and backward, streaming top-k, bin
rescoring, the row scatter-add and scatter-write, the row gather) are built
with ``nvcc`` at first use.

A model saves and loads (``save_model`` / ``BaseModel.save``,
``load_model`` / ``BaseModel.load``: a constructor-replay config and its
state, no pickled module), checkpoints its training
(``ModelCheckpoint``, ``CheckpointManager.restore_training``: the
interrupted run continues bit for bit) and exports its inference step as a
``torch.export`` program (``export_serving``, ``load_serving``) that runs
with no model code, the top-k kernels inside it as the custom ops that
importing this package registers.

A model trains on a mesh of ranks (``parallel``: one process per rank,
``parallel.initialize()``, ``make_mesh({"data": d, "model": m})``,
``fit(mesh=)``): batches split over ``data``, embedding tables split by rows
over ``model`` and looked up by an all-to-all, row-sparse updates on the
owning shard, the top-k index split by rows; save, checkpoints and exports
gather the shards through the host.
"""

from .blocks.experts import CGCBlock, ExpertsGate, MMOEBlock, PLEBlock
from .blocks.cross import CrossBlock
from .blocks.mlp import BatchNorm, Dense, DenseResidualBlock, Dropout, LayerNorm, MLPBlock
from .blocks.optimizer import LazyAdam, MultiOptimizer, SparseEmbeddingOptimizer
from .losses import binary_crossentropy, mean_absolute_error, mean_squared_error
from .convert import load_jax_params, load_torch_backend_params
from .core import (AsTabular, Block, Cond, Debug, Encoder, Filter, Lambda, MapValues, NoOp,
                   ParallelBlock, ResidualBlock, SequenceFeature, SequentialBlock, TopKEncoder,
                   TopKPrediction, WithShortcut, as_block, resolve_device)
from .core.policy import get_dtype_policy, set_dtype_policy
from .data import Dataset, Loader, generate_data, sample_batch
from .metrics import AUC, BinaryAccuracy, Metric, Precision, Recall, TopKMetricsAggregator
from .inputs import (AverageEmbeddingsByWeightFeature, DynamicEmbeddingTable, EmbeddingFeatures,
                     EmbeddingTable, Embeddings, InputBlock, InputBlockV2, PretrainedEmbeddings,
                     PretrainedEmbeddingsBlock, SequenceEmbeddingFeatures, TTEmbeddingTable,
                     string_id_hash)
from .models import (BaseModel, DCNModel, DeepFMModel, DLRMModel, History, MatrixFactorizationModel,
                     MMOEModel, Model, ModelBlock, NCFModel, PLEModel, RetrievalModelV2,
                     SessionBasedTransformerModel, TwoTowerModel, WideAndDeepModel,
                     YoutubeDNNRetrievalModel)
from .outputs import (BinaryOutput, BruteForce, CachedCrossBatchSampler, ContrastiveOutput,
                      ContrastiveSampleWeight, NextItemPredictionTask, OutputBlock,
                      ParallelPredictionBlock, PredictionTasks, RegressionOutput, TopKOutput)
from .transforms import (BroadcastToSequence, CategoryEncoding, ExpandDims, HashedCross,
                         HashedCrossAll, InBatchNegatives, PrepareFeatures, StochasticSwapNoise,
                         ToTarget)
from .utils import (Callback, CheckpointManager, CSVLogger, EarlyStopping,
                    ExamplesPerSecondCallback, ModelCheckpoint, ProfilerCallback, ServingModel,
                    TerminateOnNaN, Timing, WandbLogger, export_serving, load_model, load_serving,
                    save_model)
from .schema import (ColumnSchema, Schema, Tags, categorical_cardinalities, categorical_domains,
                     create_categorical_column, create_continuous_column)
from . import parallel
from .parallel import distributed, make_mesh
from .api import MerlinModel
from .registry import Registry
from .schema import Domain, infer_embedding_dim
from .core import ModelContext, Prediction
from .core.aggregation import ConcatFeatures, ElementwiseSum, ElementwiseSumItemMulti, StackFeatures
from .core.encoder import EmbeddingEncoder
from .inputs.continuous import Continuous, ContinuousEmbedding, ContinuousProjection
from .blocks.cross import Cross
from .blocks.dlrm import DLRMBlock
from .blocks.interaction import (DotProductInteraction, FMBlock, FMPairwiseInteraction,
                                 XDeepFmOuterProduct)
from .blocks.optimizer import split_embeddings_on_size
from .blocks.retrieval import (DualEncoderBlock, ItemRetrievalScorer, MatrixFactorizationBlock,
                               QueryItemIdsEmbeddingsBlock, TowerBlock, TwoTowerBlock)
from .outputs import (Candidate, CandidateSampler, CategoricalOutput, CategoricalTarget,
                      ColumnBasedSampleWeight, DotProduct, EmbeddingTablePrediction, FIFOQueue,
                      InBatchSampler, LogitsTemperatureScaler, ModelOutput,
                      PopularityBasedSampler, TopKLayer)
from .outputs import (BinaryClassificationTask, ItemRetrievalTask, MultiClassClassificationTask,
                      RegressionTask)
from .metrics import (MAE, RMSE, AvgPrecisionAt, ItemCoverageAt, LogLoss, MRRAt, NDCGAt,
                      NoveltyAt, PopularityBiasAt, PrecisionAt, RecallAt, TopKMetric)
from .models import MatrixFactorizationModelV2, TwoTowerModelV2
from .transforms import (ExtractMaskFromTargets, L2Norm, PopularityLogitsCorrection,
                         ReplaceMaskedEmbeddings, SequenceMaskLast, SequenceMaskLastInference,
                         SequenceMaskRandom, SequencePredictLast, SequencePredictNext,
                         SequencePredictRandom, SequenceTargetAsInput)
from .transformer.block import (AlbertBlock, AttentionWeights, BertBlock, GPT2Block, HiddenStates,
                                LastHiddenState, PoolerOutput, RobertaBlock, SequenceSummary,
                                TransformerBlock, TransformerInferenceHiddenState, XLNetBlock)
from . import api, compat
from .compat import (ContinuousFeatures, EmbeddingOptions, EmbeddingWithMetadata, FeatureConfig,
                     InBatchSamplerV2, IndexBlock, ItemSampler, LogLossMetric,
                     PopularityBasedSamplerV2, PredictionTask, PrepareListFeatures,
                     RetrievalModel, SequenceAggregator, TableConfig, TabularBlock,
                     TensorInitializer, ToDense, ToOneHot, ToSparse, TopKIndexBlock,
                     YoutubeDNNRetrievalModelV2, is_transformers_available, right_shift_layer)

__all__ = [
    "AsTabular", "AverageEmbeddingsByWeightFeature", "BatchNorm", "Block",
    "BroadcastToSequence", "CategoryEncoding", "Cond", "CrossBlock", "Debug", "Dense",
    "DenseResidualBlock", "Dropout", "DynamicEmbeddingTable", "EmbeddingFeatures",
    "EmbeddingTable", "Embeddings", "ExpandDims", "Filter", "HashedCross", "HashedCrossAll",
    "InputBlock", "Lambda", "LayerNorm", "MapValues", "NoOp", "ParallelBlock", "PrepareFeatures",
    "PretrainedEmbeddings", "PretrainedEmbeddingsBlock", "ResidualBlock",
    "SequenceEmbeddingFeatures", "SequentialBlock", "StochasticSwapNoise", "TTEmbeddingTable",
    "ToTarget", "WideAndDeepModel", "WithShortcut", "as_block", "categorical_cardinalities",
    "categorical_domains", "create_categorical_column", "create_continuous_column",
    "string_id_hash",
    "AUC", "BaseModel", "BinaryAccuracy", "BinaryOutput", "BruteForce", "CGCBlock",
    "CSVLogger", "CachedCrossBatchSampler", "Callback",
    "ColumnSchema", "ContrastiveOutput", "ContrastiveSampleWeight", "DCNModel", "DLRMModel",
    "Dataset", "DeepFMModel", "EarlyStopping", "Encoder", "ExamplesPerSecondCallback",
    "ExpertsGate", "History", "InBatchNegatives", "InputBlockV2", "LazyAdam", "Loader",
    "sample_batch",
    "MLPBlock", "MMOEBlock", "MMOEModel", "MatrixFactorizationModel", "Metric", "Model",
    "ModelBlock", "MultiOptimizer", "NCFModel", "NextItemPredictionTask", "OutputBlock",
    "PLEBlock", "PLEModel", "ParallelPredictionBlock", "Precision", "PredictionTasks",
    "Recall", "TerminateOnNaN",
    "RegressionOutput", "RetrievalModelV2", "Schema", "SequenceFeature",
    "SessionBasedTransformerModel",
    "SparseEmbeddingOptimizer", "Tags", "TopKEncoder", "TopKMetricsAggregator", "TopKOutput",
    "TopKPrediction", "TwoTowerModel", "YoutubeDNNRetrievalModel", "binary_crossentropy", "generate_data",
    "get_dtype_policy", "load_jax_params", "load_torch_backend_params", "mean_absolute_error",
    "mean_squared_error",
    "resolve_device", "set_dtype_policy",
    "CheckpointManager", "ModelCheckpoint", "ProfilerCallback", "ServingModel", "Timing",
    "WandbLogger", "export_serving", "load_model", "load_serving", "save_model",
    "make_mesh", "parallel",
    "AlbertBlock", "AttentionWeights", "AvgPrecisionAt", "BertBlock", "BinaryClassificationTask",
    "Candidate", "CandidateSampler", "CategoricalOutput", "CategoricalTarget",
    "ColumnBasedSampleWeight", "ConcatFeatures", "Continuous", "ContinuousEmbedding",
    "ContinuousFeatures", "ContinuousProjection", "Cross", "DLRMBlock", "Domain", "DotProduct",
    "DotProductInteraction", "DualEncoderBlock", "ElementwiseSum", "ElementwiseSumItemMulti",
    "EmbeddingEncoder", "EmbeddingOptions", "EmbeddingTablePrediction", "EmbeddingWithMetadata",
    "ExtractMaskFromTargets", "FIFOQueue", "FMBlock", "FMPairwiseInteraction", "FeatureConfig",
    "GPT2Block", "HiddenStates", "InBatchSampler", "InBatchSamplerV2", "IndexBlock",
    "ItemCoverageAt", "ItemRetrievalScorer", "ItemRetrievalTask", "ItemSampler", "L2Norm",
    "LastHiddenState", "LogLoss", "LogLossMetric", "LogitsTemperatureScaler", "MAE", "MRRAt",
    "MatrixFactorizationBlock", "MatrixFactorizationModelV2", "MerlinModel", "ModelContext",
    "ModelOutput", "MultiClassClassificationTask", "NDCGAt", "NoveltyAt", "PoolerOutput",
    "PopularityBasedSampler", "PopularityBasedSamplerV2", "PopularityBiasAt",
    "PopularityLogitsCorrection", "PrecisionAt", "Prediction", "PredictionTask",
    "PrepareListFeatures", "QueryItemIdsEmbeddingsBlock", "RMSE", "RecallAt", "Registry",
    "RegressionTask", "ReplaceMaskedEmbeddings", "RetrievalModel", "RobertaBlock",
    "SequenceAggregator", "SequenceMaskLast", "SequenceMaskLastInference", "SequenceMaskRandom",
    "SequencePredictLast", "SequencePredictNext", "SequencePredictRandom", "SequenceSummary",
    "SequenceTargetAsInput", "StackFeatures", "TableConfig", "TabularBlock", "TensorInitializer",
    "ToDense", "ToOneHot", "ToSparse", "TopKIndexBlock", "TopKLayer", "TopKMetric", "TowerBlock",
    "TransformerBlock", "TransformerInferenceHiddenState", "TwoTowerBlock", "TwoTowerModelV2",
    "XDeepFmOuterProduct", "XLNetBlock", "YoutubeDNNRetrievalModelV2", "api", "compat",
    "distributed", "infer_embedding_dim", "is_transformers_available", "right_shift_layer",
    "split_embeddings_on_size",
]
