"""Logit corrections (``models_tpu/transforms/bias.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.block import Block
from ..core.types import Prediction
from ..outputs.base import LogitsTemperatureScaler  # noqa: F401  (the JAX package's home of it)


class PopularityLogitsCorrection(Block):
    """A contrastive head's ``post``: subtract ``reg_factor * log(p)`` from
    each negative's logit, ``p`` the candidate's share of the item
    frequencies (at least 1e-12), gathered by the Prediction's
    ``negative_candidate_ids``; column 0, the positive, is left as it is.
    The log-probabilities are a buffer, so they move with the model."""

    def __init__(self, item_frequencies, reg_factor: float = 1.0, device=None):
        super().__init__()
        freqs = torch.as_tensor(np.asarray(item_frequencies, np.float32), device=device)
        probs = freqs / torch.clamp_min(freqs.sum(), 1.0)
        self.register_buffer("log_probs", torch.log(torch.clamp_min(probs, 1e-12)))
        self.reg_factor = reg_factor

    @classmethod
    def from_parquet(cls, path: str, frequency_col: str = "frequency", **kwargs):
        """The item frequencies from the column ``frequency_col`` of a
        parquet file (read by the port's codec, ``data/parquet.py``)."""
        from ..data import parquet

        return cls(parquet.read_table(path, [frequency_col])[frequency_col], **kwargs)

    def correction(self, candidate_ids: torch.Tensor) -> torch.Tensor:
        return self.reg_factor * self.log_probs[candidate_ids.long()]

    def forward(self, inputs, **kwargs):
        if not isinstance(inputs, Prediction) or inputs.negative_candidate_ids is None:
            return inputs
        corr = self.correction(inputs.negative_candidate_ids)
        logits = inputs.outputs
        corrected = torch.cat(
            [logits[:, :1], logits[:, 1:] - (corr[None, :] if corr.ndim == 1 else corr)], dim=1)
        return inputs._replace(outputs=corrected)
