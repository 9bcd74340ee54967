"""Streaming sampled-softmax contrastive loss (``models_tpu/ops/contrastive.py``).

    loss_i = logsumexp([pos_i, x_i1 .. x_iN]) - pos_i

weighted over the rows, where ``pos_i = (q_i . p_i + pos_bias_i) / T`` and
``x_ij`` are the negatives' logits of :mod:`.flash_ce`. The forward is the
log-sum-exp kernel K1; the backward recomputes the logits in K2 (the query
gradient) and K3 (the negatives' gradient), so the (Q, N) logits are never
held. On CUDA tensors the kernels always run; on CPU tensors their plain
versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_ce


def _loss_from_lse(pos_logit, m, s, weights):
    per = (m + torch.log(s)) - pos_logit
    if weights is None:
        return per.mean()
    return (per * weights).sum() / weights.sum().clamp_min(1e-9)


class _SampledSoftmaxLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias, pos_bias,
                temperature):
        pos_logit = (query * pos_emb).sum(dim=1) / temperature
        if pos_bias is not None:
            # the bias lands on the raw score, before the temperature
            pos_logit = pos_logit + pos_bias / temperature
        downscore = pos_id is not None and neg_id is not None
        m, s = flash_ce.lse_forward(query, pos_logit, neg_emb, pos_id, neg_id, neg_bias,
                                    temperature, downscore)
        ctx.save_for_backward(query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias,
                              pos_logit, m, s)
        ctx.temperature = temperature
        return _loss_from_lse(pos_logit, m, s, weights)

    @staticmethod
    def backward(ctx, g):
        query, pos_emb, neg_emb, pos_id, neg_id, weights, neg_bias, pos_logit, m, s = (
            ctx.saved_tensors)
        T = ctx.temperature
        lse = m + torch.log(s)
        if weights is None:
            w = torch.full_like(lse, 1.0 / query.shape[0])
        else:
            w = weights / weights.sum().clamp_min(1e-9)
        gw = (g * w).contiguous()
        # d loss_i / d x_ij = softmax_ij; d loss_i / d pos_i = softmax_i0 - 1
        coef_pos = gw * (torch.exp(pos_logit - lse) - 1.0) / T
        downscore = pos_id is not None and neg_id is not None
        d_query = coef_pos[:, None] * pos_emb + flash_ce.grad_query(
            query, neg_emb, lse, gw, pos_id, neg_id, neg_bias, T, downscore)
        d_pos = coef_pos[:, None] * query
        d_neg = flash_ce.grad_neg(query, neg_emb, lse, gw, pos_id, neg_id, neg_bias, T,
                                  downscore)
        return d_query, d_pos, d_neg, None, None, None, None, None, None


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
