from .base import BaseModel, History, Model, ModelBlock
from .benchmark import NCFModel
from .multi_task import MMOEModel, PLEModel
from .ranking import DCNModel, DeepFMModel, DLRMModel, WideAndDeepModel
from .retrieval import (MatrixFactorizationModel, MatrixFactorizationModelV2, RetrievalModelV2,
                        TwoTowerModel, TwoTowerModelV2, YoutubeDNNRetrievalModel)
from .session import SessionBasedTransformerModel

__all__ = ["BaseModel", "DCNModel", "DLRMModel", "DeepFMModel", "History", "MMOEModel",
           "MatrixFactorizationModel", "MatrixFactorizationModelV2", "Model", "ModelBlock",
           "NCFModel", "PLEModel", "RetrievalModelV2",
           "SessionBasedTransformerModel", "TwoTowerModel", "TwoTowerModelV2",
           "WideAndDeepModel", "YoutubeDNNRetrievalModel"]
