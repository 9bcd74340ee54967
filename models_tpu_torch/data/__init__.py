from .dataset import Dataset
from .loader import ROW_VALID_KEY, Loader, pad_ragged
from .synthetic import KNOWN_DATASETS, generate_data, known_schema

__all__ = [
    "Dataset", "Loader", "ROW_VALID_KEY", "pad_ragged",
    "KNOWN_DATASETS", "generate_data", "known_schema",
]
