from .base import InputBlock, InputBlockV2
from .continuous import ConcatDict, Continuous, ContinuousEmbedding, ContinuousProjection
from .dynamic import DynamicEmbeddingTable, string_id_hash
from .embedding import (AverageEmbeddingsByWeightFeature, EmbeddingFeatures, EmbeddingTable,
                        Embeddings, FusedEmbeddingTables, PretrainedEmbeddings,
                        PretrainedEmbeddingsBlock, SequenceEmbeddingFeatures)
from .tt_embedding import TTEmbeddingTable

__all__ = ["AverageEmbeddingsByWeightFeature", "ConcatDict", "Continuous",
           "ContinuousEmbedding", "ContinuousProjection", "DynamicEmbeddingTable",
           "EmbeddingFeatures", "EmbeddingTable", "Embeddings", "FusedEmbeddingTables",
           "InputBlock", "InputBlockV2", "PretrainedEmbeddings", "PretrainedEmbeddingsBlock",
           "SequenceEmbeddingFeatures", "TTEmbeddingTable", "string_id_hash"]
