"""Streaming sampled-softmax contrastive loss (``models_tpu/ops/contrastive.py``).

    loss_i = logsumexp([pos_i, x_i1 .. x_iN]) - pos_i

weighted over the rows, where ``pos_i = (q_i . p_i + pos_bias_i) / T`` and
``x_ij`` are the negatives' logits of :mod:`.flash_ce`. The forward is the
log-sum-exp kernel K1; the backward recomputes the logits in K2 (the query
gradient) and K3 (the negatives' gradient), so the (Q, N) logits are never
held. On CUDA tensors the kernels always run; on CPU tensors their plain
versions. Query and embeddings are float32, or bf16 under the
``mixed_bfloat16`` policy: the logits, the loss and the gradients are then
taken in float32 on the operands widened (bf16 products are exact in
float32), and each cotangent is returned in its primal's dtype, as the JAX
package's custom VJP returns them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.collectives import in_data_scope, weight_total
from . import flash_ce


def _weight_sum(query, weights) -> Optional[torch.Tensor]:
    """The weighted mean's denominator: the rows' total weight, under a mesh
    step the data line's total over its size
    (``parallel/collectives.py::weight_total``); None for the plain mean of
    unweighted rows outside one."""
    if weights is None:
        if not in_data_scope():
            return None
        weights = torch.ones(query.shape[0], device=query.device)
    return weight_total(weights.sum()).clamp_min(1e-9)


def _loss_from_lse(pos_logit, m, s, weights, denom=None):
    per = (m + torch.log(s)) - pos_logit
    if weights is None and denom is None:
        return per.mean()
    if denom is None:
        denom = weights.sum().clamp_min(1e-9)
    return (per if weights is None else per * weights).sum() / denom


def loss_stats(query, pos_emb, neg_emb, pos_id, neg_id, neg_bias, pos_bias, temperature):
    """(pos_logit, m, s), float32: the positive logits and K1's running (max,
    sum) over them and the negatives."""
    pos_logit = (query.float() * pos_emb.float()).sum(dim=1) / temperature
    if pos_bias is not None:
        # the bias lands on the raw score, before the temperature
        pos_logit = pos_logit + pos_bias / temperature
    downscore = pos_id is not None and neg_id is not None
    m, s = flash_ce.lse_forward(query, pos_logit, neg_emb, pos_id, neg_id, neg_bias,
                                temperature, downscore)
    return pos_logit, m, s


def loss_cotangents(g, query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias, pos_logit,
                    m, s, temperature, denom=None):
    """The loss's float32 cotangents (d_query, d_pos, d_neg) for the upstream
    gradient ``g``, before each is rounded to its primal's dtype: K2 and K3
    recompute the negatives' logits from :func:`loss_stats`' (m, s).
    ``denom``: the forward's weighted-mean denominator (by default this
    rank's own)."""
    T = temperature
    lse = m + torch.log(s)
    if weights is None:
        w = (torch.full_like(lse, 1.0 / query.shape[0]) if denom is None
             else torch.ones_like(lse) / denom)
    else:
        w = weights / (weights.sum().clamp_min(1e-9) if denom is None else denom)
    gw = (g * w).contiguous()
    # d loss_i / d x_ij = softmax_ij; d loss_i / d pos_i = softmax_i0 - 1
    coef_pos = gw * (torch.exp(pos_logit - lse) - 1.0) / T
    downscore = pos_id is not None and neg_id is not None
    d_query = coef_pos[:, None] * pos_emb.float() + flash_ce.grad_query(
        query, neg_emb, lse, gw, pos_id, neg_id, neg_bias, T, downscore)
    d_pos = coef_pos[:, None] * query.float()
    d_neg = flash_ce.grad_neg(query, neg_emb, lse, gw, pos_id, neg_id, neg_bias, T, downscore)
    return d_query, d_pos, d_neg


class _SampledSoftmaxLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias, pos_bias,
                temperature):
        pos_logit, m, s = loss_stats(query, pos_emb, neg_emb, pos_id, neg_id, neg_bias, pos_bias,
                                     temperature)
        denom = _weight_sum(query, weights)
        ctx.save_for_backward(query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias,
                              pos_logit, m, s, denom)
        ctx.temperature = temperature
        return _loss_from_lse(pos_logit, m, s, weights, denom)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        d_query, d_pos, d_neg = loss_cotangents(g, *saved[:10], ctx.temperature,
                                                denom=saved[10])
        query, pos_emb, neg_emb = saved[:3]
        return (d_query.to(query.dtype), d_pos.to(pos_emb.dtype), d_neg.to(neg_emb.dtype),
                None, None, None, None, None, None)


def _ids(x):
    return None if x is None else x.to(torch.int32).contiguous()


def _floats(x):
    return None if x is None else x.detach().to(torch.float32).contiguous()


def sampled_softmax_loss(
    query: torch.Tensor,                     # (Q, D)
    pos_emb: torch.Tensor,                   # (Q, D)
    neg_emb: torch.Tensor,                   # (N, D), may be pos_emb itself
    pos_id: Optional[torch.Tensor] = None,   # (Q,)
    neg_id: Optional[torch.Tensor] = None,   # (N,)
    weights: Optional[torch.Tensor] = None,  # (Q,)
    neg_bias: Optional[torch.Tensor] = None,  # (N,) additive logit bias (logQ)
    temperature: float = 1.0,
    pos_bias: Optional[torch.Tensor] = None,  # (Q,)
) -> torch.Tensor:
    """The weighted mean of the rows' sampled-softmax CE, a scalar.

    Negatives equal to the row's positive id are masked when both id vectors
    are given. ``weights`` and the biases are constants: no gradient reaches
    them, as in the JAX package's custom VJP. Gradients flow to ``query``,
    ``pos_emb`` and ``neg_emb``, summed where the last two are one tensor."""
    return _SampledSoftmaxLoss.apply(
        query.contiguous(), pos_emb.contiguous(), neg_emb.contiguous(), _ids(pos_id),
        _ids(neg_id), _floats(weights), _floats(neg_bias), _floats(pos_bias), float(temperature),
    )
