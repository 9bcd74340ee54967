from .cross import Cross, CrossBlock
from .dlrm import DLRMBlock
from .interaction import (DotProductInteraction, FMBlock, FMPairwiseInteraction,
                          XDeepFmOuterProduct)
from .mlp import (BatchNorm, Dense, DenseMaybeLowRank, DenseResidualBlock, Dropout, LayerNorm,
                  MLPBlock, get_activation)

__all__ = ["BatchNorm", "Cross", "CrossBlock", "DLRMBlock", "Dense", "DenseMaybeLowRank",
           "DenseResidualBlock", "DotProductInteraction", "Dropout", "FMBlock",
           "FMPairwiseInteraction", "LayerNorm", "MLPBlock", "XDeepFmOuterProduct",
           "get_activation"]
