from .cross import Cross, CrossBlock
from .dlrm import DLRMBlock
from .interaction import (DotProductInteraction, FMBlock, FMPairwiseInteraction,
                          XDeepFmOuterProduct)
from .mlp import (BatchNorm, Dense, DenseMaybeLowRank, DenseResidualBlock, Dropout, LayerNorm,
                  MLPBlock, get_activation)
from .retrieval import (DualEncoderBlock, ItemRetrievalScorer, MatrixFactorizationBlock,
                        QueryItemIdsEmbeddingsBlock, TowerBlock, TwoTowerBlock)

__all__ = ["BatchNorm", "Cross", "CrossBlock", "DLRMBlock", "Dense", "DenseMaybeLowRank",
           "DenseResidualBlock", "DotProductInteraction", "Dropout", "DualEncoderBlock", "FMBlock",
           "FMPairwiseInteraction", "ItemRetrievalScorer", "LayerNorm", "MLPBlock",
           "MatrixFactorizationBlock", "QueryItemIdsEmbeddingsBlock", "TowerBlock",
           "TwoTowerBlock", "XDeepFmOuterProduct", "get_activation"]
