"""Training utilities: the callbacks ``fit`` takes."""

from .callbacks import (Callback, CSVLogger, EarlyStopping, ExamplesPerSecondCallback,
                        TerminateOnNaN)

__all__ = ["CSVLogger", "Callback", "EarlyStopping", "ExamplesPerSecondCallback",
           "TerminateOnNaN"]
