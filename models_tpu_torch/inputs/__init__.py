from .base import InputBlockV2
from .continuous import ConcatDict, Continuous, ContinuousEmbedding, ContinuousProjection
from .embedding import EmbeddingTable, Embeddings, FusedEmbeddingTables

__all__ = ["ConcatDict", "Continuous", "ContinuousEmbedding", "ContinuousProjection",
           "EmbeddingTable", "Embeddings", "FusedEmbeddingTables", "InputBlockV2"]
