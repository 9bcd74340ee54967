from .base import History, Model
from .benchmark import NCFModel
from .ranking import DCNModel, DeepFMModel, DLRMModel
from .retrieval import (MatrixFactorizationModel, MatrixFactorizationModelV2, RetrievalModelV2,
                        TwoTowerModel, TwoTowerModelV2, YoutubeDNNRetrievalModel)
from .session import SessionBasedTransformerModel

__all__ = ["DCNModel", "DLRMModel", "DeepFMModel", "History", "MatrixFactorizationModel",
           "MatrixFactorizationModelV2", "Model", "NCFModel", "RetrievalModelV2",
           "SessionBasedTransformerModel", "TwoTowerModel", "TwoTowerModelV2",
           "YoutubeDNNRetrievalModel"]
