"""A leaf of the benchmark's naming (``kinds/<kind>/reference.py::leaf_specs``)
as rows of one of the program's parameters: the benchmark fills it in place
and reads its value and its gradient there."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Leaf:
    param: torch.nn.Parameter
    rows: Optional[int] = None  # the leaf's rows (a table padded, or fused), from row ``start``
    start: int = 0

    def _view(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.rows is None else t[self.start:self.start + self.rows]

    def value(self) -> torch.Tensor:
        return self._view(self.param.data)

    def grad(self) -> Optional[torch.Tensor]:
        g = self.param.grad
        return None if g is None else self._view(g)
