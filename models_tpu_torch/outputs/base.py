"""Model output heads (``models_tpu/outputs/base.py``): the temperature scaler
and the part of ``ModelOutput`` the contrastive head uses."""

from __future__ import annotations

from typing import Optional

from ..core.block import Block


class LogitsTemperatureScaler(Block):
    """logits / T."""

    def __init__(self, temperature: float):
        super().__init__()
        self.temperature = float(temperature)

    def forward(self, inputs, **kwargs):
        return inputs / self.temperature


class ModelOutput(Block):
    """Head base: the bound target, the loss it defaults to, and the
    temperature scaler (present only when T != 1). The head's ``block_name``,
    ``"<target>/<class>"``, names its loss in the logs."""

    default_loss: str = "mse"

    def __init__(self, target: Optional[str] = None, post=None, logits_temperature: float = 1.0):
        super().__init__(
            block_name=f"{target}/{type(self).__name__}" if target else type(self).__name__)
        if post is not None:
            raise NotImplementedError(
                "a post block on a head (ContrastiveSampleWeight) is not ported yet "
                "(ROADMAP.md queue 1)")
        self.target = target
        self.logits_scaler = (
            LogitsTemperatureScaler(logits_temperature) if logits_temperature != 1.0 else None
        )

    def default_metrics(self) -> list:
        return []

    def bind_target(self, targets):
        if targets is None:
            return None
        if isinstance(targets, dict):
            if self.target is not None:
                return targets.get(self.target)
            if len(targets) == 1:
                return next(iter(targets.values()))
            return None
        return targets
