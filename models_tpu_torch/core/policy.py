"""The compute-dtype policy (a copy of ``models_tpu/core/policy.py``).

``mixed_bfloat16`` casts the inputs of the hot products to bfloat16 (the
towers' Dense layers, the contrastive logits, the fused sampled-softmax
operands) while master weights and every product's result stay float32, as
JAX's ``preferred_element_type=jnp.float32`` keeps them. torch rounds a
bf16 x bf16 product to bf16, so the port takes such a product on the
operands widened to float32 (``a.float() @ b.float()``): bf16 x bf16
products are exact in float32, so the result is the one the JAX package
computes, up to the order of the sums, and the backward rounds each
operand's gradient to bf16, as JAX's transpose of such a product does. The
policy is global, as in the JAX package.
"""

from __future__ import annotations

import torch

_POLICIES = ("float32", "mixed_bfloat16")
_policy = "float32"


def set_dtype_policy(name: str) -> None:
    global _policy
    if name not in _POLICIES:
        raise ValueError(f"Unknown dtype policy {name!r}; options: {_POLICIES}")
    _policy = name


def get_dtype_policy() -> str:
    return _policy


def compute_dtype() -> torch.dtype:
    return torch.bfloat16 if _policy == "mixed_bfloat16" else torch.float32


def cast_compute(x):
    """Cast a floating tensor to the policy's compute dtype (ints and bools
    pass). Each call is its own cast: a tensor used twice is cast twice, so
    that autograd sums the two bf16 cotangents in float32 at the source, as
    JAX sums those of two ``astype`` calls."""
    cd = compute_dtype()
    if cd == torch.float32 or not (torch.is_tensor(x) and x.is_floating_point()):
        return x
    return x.to(cd)

