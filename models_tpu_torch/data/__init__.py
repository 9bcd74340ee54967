from .dataset import Dataset
from .loader import ROW_VALID_KEY, Loader, pad_ragged, sample_batch
from .synthetic import KNOWN_DATASETS, generate_data, known_schema
from . import datasets, workflow
from .datasets import (get_aliccp, get_booking, get_criteo, get_dressipi2022,
                       get_ecommerce_transactions, get_movielens, get_sigir, get_tenrec)

__all__ = [
    "Dataset", "Loader", "ROW_VALID_KEY", "pad_ragged", "sample_batch",
    "KNOWN_DATASETS", "generate_data", "known_schema", "datasets", "workflow",
    "get_movielens", "get_criteo", "get_aliccp", "get_booking", "get_dressipi2022",
    "get_sigir", "get_tenrec", "get_ecommerce_transactions",
]
