from .base import InputBlockV2
from .continuous import Continuous
from .embedding import EmbeddingTable, Embeddings

__all__ = ["InputBlockV2", "Continuous", "EmbeddingTable", "Embeddings"]
