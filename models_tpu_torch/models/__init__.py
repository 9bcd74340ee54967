from .base import History, Model
from .retrieval import RetrievalModelV2, TwoTowerModel

__all__ = ["History", "Model", "RetrievalModelV2", "TwoTowerModel"]
