"""Shared numeric constants (a copy of ``models_tpu/core/constants.py``)."""

import numpy as np

# Sentinel logit for masked, false-negative and invalid candidate scores:
# float16.min / 100 (about -655.04), deep enough that exp(x - max) underflows
# to exactly 0, finite, and not float32's minimum (``ops/topk.py::NEG_INF``).
MIN_FLOAT = float(np.finfo(np.float16).min) / 100.0

# Added to sampling probabilities before the log of the logQ correction.
LOGQ_EPS = 1e-16
