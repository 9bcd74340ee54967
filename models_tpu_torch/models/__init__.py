from .base import Model
from .retrieval import RetrievalModelV2, TwoTowerModel

__all__ = ["Model", "RetrievalModelV2", "TwoTowerModel"]
