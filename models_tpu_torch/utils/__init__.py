"""Training and persistence utilities: the callbacks ``fit`` takes, saving
and loading models, step checkpoints, serving export."""

from .callbacks import (Callback, CSVLogger, EarlyStopping, ExamplesPerSecondCallback,
                        ProfilerCallback, TerminateOnNaN, WandbLogger)
from .checkpoint import CheckpointManager, ModelCheckpoint
from .io import ServingModel, export_serving, load_model, load_serving, save_model
from .misc import Timing

__all__ = ["CSVLogger", "Callback", "CheckpointManager", "EarlyStopping",
           "ExamplesPerSecondCallback", "ModelCheckpoint", "ProfilerCallback", "ServingModel",
           "TerminateOnNaN", "Timing", "WandbLogger", "export_serving", "load_model",
           "load_serving", "save_model"]
