"""Multi-task mixture-of-experts blocks (``models_tpu/blocks/experts.py``):
MMOE (one softmax gate per task over shared experts) and PLE / CGC (task
experts and shared experts, a gate per task, and a shared gate between
stacked layers).

The zoo models give the input block's width (``in_features``); left out,
the experts and gates build at their first call. ``MMOEBlock`` takes
``gate_block`` and, as the JAX package's, does not use it. An expert is one block (an
:func:`~models_tpu_torch.blocks.mlp.MLPBlock` where widths are given), so
that ``load_jax_params`` maps the JAX experts one to one; the experts run
one after another and stack to (B, E, D). The first expert of a group is
the given block; every other one is a :func:`fresh_copy` of it with its
weights drawn anew from its own salt (a plain deep copy would give E equal
experts, whose gates then see one output E times).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from ..core.block import Block, fresh_copy
from ..core.combinators import SequentialBlock
from .mlp import Dense, MLPBlock

# salts of fresh copies: a group's experts take consecutive salts, groups
# (CGC's shared group, then one a task) are GROUP_SALT apart and PLE's layers
# LAYER_SALT, so that no two copies of a model draw alike
GROUP_SALT = 1009
LAYER_SALT = GROUP_SALT * GROUP_SALT


def _expert(expert_block, in_features: Optional[int], seed: int, device) -> nn.Module:
    """An expert from its widths (an MLPBlock over ``in_features``) or as given."""
    if isinstance(expert_block, (list, tuple)):
        return MLPBlock(list(expert_block), seed=seed, in_features=in_features, device=device)
    return expert_block


class ExpertsGate(Block):
    """A softmax gate mixing stacked expert outputs: ``(gate_input (B, F),
    experts (B, E, D)) -> (B, D)``; ``gate`` is a bias-free Dense(F, E)."""

    def __init__(self, in_features: Optional[int], num_experts: int, seed: int = 0,
                 device=None):
        super().__init__()
        self.gate = Dense(num_experts, use_bias=False, seed=seed, in_features=in_features,
                          device=device)

    def forward(self, inputs, **kwargs):
        gate_input, experts = inputs
        weights = torch.softmax(self.gate(gate_input), dim=-1)
        return torch.einsum("be,bed->bd", weights, experts)


class _StackedExperts(Block):
    """``num_experts`` experts over the same input, stacked on axis 1:
    (B, E, D). Expert 0 is ``expert_block``; expert i a fresh copy of it,
    salted ``salt + i``."""

    def __init__(self, expert_block: nn.Module, num_experts: int, salt: int = 0):
        super().__init__()
        self.experts = nn.ModuleList(
            [expert_block] + [fresh_copy(expert_block, salt + i) for i in range(1, num_experts)])
        self.out_features = expert_block.out_features

    def forward(self, inputs, **kwargs):
        return torch.stack([e(inputs, **kwargs) for e in self.experts], dim=1)


class MMOEBlock(Block):
    """Multi-gate mixture of experts: shared experts, one gate per task over
    the block's input. Output: a dict task -> (B, D), which the heads of
    ``OutputBlock`` pick by their target."""

    def __init__(self, outputs: Sequence[str], expert_block, in_features: Optional[int] = None,
                 num_experts: int = 4, gate_block: Optional[nn.Module] = None, seed: int = 0,
                 device=None):
        super().__init__()
        expert = _expert(expert_block, in_features, seed, device)
        self.experts = _StackedExperts(expert, num_experts)
        self.task_names = list(outputs)
        self.gates = nn.ModuleDict({t: ExpertsGate(in_features, num_experts, seed=seed + i,
                                                   device=device)
                                    for i, t in enumerate(self.task_names)})
        self.out_features = self.experts.out_features

    def forward(self, inputs, **kwargs):
        experts = self.experts(inputs, **kwargs)
        return {t: self.gates[t]((inputs, experts)) for t in self.task_names}


class CGCBlock(Block):
    """Customized gate control: each task mixes its own experts and the
    shared ones through its gate; unless ``final_layer``, a shared gate over
    every expert gives the ``"shared"`` output for the next layer. The input
    is a tensor, or (a stacked layer) the dict of the layer before it, each
    branch reading its task's entry, else ``"shared"``."""

    def __init__(self, outputs: Sequence[str], expert_block, in_features: Optional[int] = None,
                 num_task_experts: int = 1, num_shared_experts: int = 1,
                 final_layer: bool = False, seed: int = 0, salt: int = 0, device=None):
        super().__init__()
        template = _expert(expert_block, in_features, seed, device)
        self.task_names = list(outputs)
        self.final_layer = final_layer

        def group(g: int, n: int) -> _StackedExperts:
            return _StackedExperts(fresh_copy(template, salt + GROUP_SALT * g), n,
                                   salt + GROUP_SALT * g)

        self.shared_experts = group(0, num_shared_experts)
        self.task_experts = nn.ModuleDict(
            {t: group(j + 1, num_task_experts) for j, t in enumerate(self.task_names)})
        self.task_gates = nn.ModuleDict(
            {t: ExpertsGate(in_features, num_task_experts + num_shared_experts, seed=seed + i,
                            device=device)
             for i, t in enumerate(self.task_names)})
        total = num_shared_experts + num_task_experts * len(self.task_names)
        self.shared_gate = (None if final_layer else
                            ExpertsGate(in_features, total, seed=seed + 91, device=device))
        self.out_features = template.out_features

    def forward(self, inputs, **kwargs):
        def branch_input(name):
            if isinstance(inputs, dict):
                return inputs.get(name, inputs.get("shared"))
            return inputs

        shared_in = branch_input("shared")
        shared_out = self.shared_experts(shared_in, **kwargs)
        outs: Dict[str, torch.Tensor] = {}
        task_outs = []
        for t in self.task_names:
            ti = branch_input(t)
            te = self.task_experts[t](ti, **kwargs)
            task_outs.append(te)
            outs[t] = self.task_gates[t]((ti, torch.cat([te, shared_out], dim=1)))
        if self.shared_gate is not None:
            outs["shared"] = self.shared_gate((shared_in, torch.cat(task_outs + [shared_out],
                                                                    dim=1)))
        return outs


def PLEBlock(outputs: Sequence[str], expert_block: Union[Sequence[int], nn.Module],
             in_features: Optional[int] = None, num_layers: int = 2, num_task_experts: int = 1,
             num_shared_experts: int = 1, seed: int = 0, device=None) -> SequentialBlock:
    """Progressive layered extraction: ``num_layers`` CGC layers, the last
    one final. Layer 0 reads ``in_features``, each later layer the experts'
    width. ``expert_block``: the expert's widths, or a block whose input and
    output widths are both ``in_features`` (every expert of every layer a
    fresh copy of it)."""
    layers = []
    width = in_features
    for i in range(num_layers):
        layer = CGCBlock(outputs, expert_block, width, num_task_experts=num_task_experts,
                         num_shared_experts=num_shared_experts, final_layer=i == num_layers - 1,
                         seed=seed + 13 * i, salt=LAYER_SALT * i, device=device)
        layers.append(layer)
        width = layer.out_features
    block = SequentialBlock(layers, block_name="PLEBlock")
    block.out_features = width
    return block
