from .cross import Cross, CrossBlock
from .dlrm import DLRMBlock
from .experts import CGCBlock, ExpertsGate, MMOEBlock, PLEBlock
from .interaction import (DotProductInteraction, FMBlock, FMPairwiseInteraction,
                          XDeepFmOuterProduct)
from .mlp import (BatchNorm, Dense, DenseMaybeLowRank, DenseResidualBlock, Dropout, LayerNorm,
                  MLPBlock, get_activation)
from .retrieval import (DualEncoderBlock, ItemRetrievalScorer, MatrixFactorizationBlock,
                        QueryItemIdsEmbeddingsBlock, TowerBlock, TwoTowerBlock)

__all__ = ["BatchNorm", "CGCBlock", "Cross", "CrossBlock", "DLRMBlock", "Dense",
           "DenseMaybeLowRank", "DenseResidualBlock", "DotProductInteraction", "Dropout",
           "DualEncoderBlock", "ExpertsGate", "FMBlock", "FMPairwiseInteraction",
           "ItemRetrievalScorer", "LayerNorm", "MLPBlock", "MMOEBlock",
           "MatrixFactorizationBlock", "PLEBlock", "QueryItemIdsEmbeddingsBlock", "TowerBlock",
           "TwoTowerBlock", "XDeepFmOuterProduct", "get_activation"]
