from .base import History, Model
from .benchmark import NCFModel
from .ranking import DCNModel, DeepFMModel, DLRMModel
from .retrieval import RetrievalModelV2, TwoTowerModel
from .session import SessionBasedTransformerModel

__all__ = ["DCNModel", "DLRMModel", "DeepFMModel", "History", "Model", "NCFModel",
           "RetrievalModelV2", "SessionBasedTransformerModel", "TwoTowerModel"]
