"""The session transformer (``models_tpu/transformer/block.py``): a pre-norm
encoder over (B, L, D) session representations.

- a padding-aware attention mask from the input :class:`SequenceFeature`,
  with a causal triangle (GPT2-style next-item) or without (BERT-style
  masked LM);
- learned absolute positions (``pos_emb``), or XLNet's relative attention:
  the scores split into a content term ``(q + u) . k`` and a position term
  ``(q + v) . r(j - i)``, ``r`` the sinusoidal encodings of the offsets
  through a learned ``wr``;
- ALBERT-style sharing: one layer applied ``n_layers`` times;
- the introspection taps (every layer's hidden states, attention weights)
  left in the context on request.

The JAX package has no kernel here: attention and the products are
library calls. Each product takes its operands through ``cast_compute``
with a float32 result (bf16 operands under ``mixed_bfloat16``); the
LayerNorms, the softmax and the residuals stay float32. Masked logits take
float32's lowest value and the softmax runs over every position, as the
JAX package takes it, so that a row with no valid key (a padded query, or
the last valid position after ``SequencePredictNext``) averages the values
uniformly and stays finite. The weights keep the JAX layout, (in, out).
The input width is given at construction (``in_features``): a width other
than ``d_model`` gets the projection ``in_proj``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..blocks.mlp import Dense, Dropout, NNXLayerNorm, _glorot, get_activation
from ..core.aggregation import sequence_last, sequence_mean
from ..core.block import Block
from ..core.config import record_call
from ..core.policy import cast_compute
from ..core.types import SequenceFeature

_gelu = get_activation("gelu")  # jax.nn.gelu: the tanh form


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` on the operands in the compute dtype, float32 result."""
    return cast_compute(a).float() @ cast_compute(b).float()


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, cast_compute(a).float(), cast_compute(b).float())


def _trunc_normal(shape, std: float, seed: int, device) -> torch.Tensor:
    """A normal truncated at 2 sigma (``jax.random.truncated_normal(-2, 2) *
    std``), drawn from ``seed``."""
    t = torch.empty(shape, device=device)
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=torch.Generator(t.device).manual_seed(seed))
    return t


class TransformerLayer(Block):
    """Pre-norm attention and feed-forward sublayers."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dropout: float, seed: int,
                 relative_attention: bool = False, device=None):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} not divisible by n_heads={n_heads}")
        if relative_attention and d_model % 2:
            raise ValueError("relative attention needs an even d_model (sin/cos pairs)")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.relative = relative_attention
        s = seed + 101  # the JAX seeds' formula; the draws differ

        def glorot(shape, i):
            return nn.Parameter(_glorot(shape, s * 16 + i, device))

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        if relative_attention:
            self.wr = glorot((d_model, d_model), 7)
            self.u = zeros(n_heads, self.d_head)
            self.v = zeros(n_heads, self.d_head)
        else:
            self.wr = self.u = self.v = None
        self.wq, self.wk = glorot((d_model, d_model), 0), glorot((d_model, d_model), 1)
        self.wv, self.wo = glorot((d_model, d_model), 2), glorot((d_model, d_model), 3)
        self.bq, self.bk, self.bv, self.bo = (zeros(d_model) for _ in range(4))
        self.w1, self.b1 = glorot((d_model, d_ff), 4), zeros(d_ff)
        self.w2, self.b2 = glorot((d_ff, d_model), 5), zeros(d_model)
        self.ln1 = NNXLayerNorm(d_model, device=device)
        self.ln2 = NNXLayerNorm(d_model, device=device)
        self.drop1 = Dropout(dropout, seed=seed + 21, device=device)
        self.drop2 = Dropout(dropout, seed=seed + 22, device=device)

    def _proj(self, x, w, b):
        B, L, _ = x.shape
        return (_mm(x, w) + b).reshape(B, L, self.n_heads, self.d_head)

    def _rel_encoding(self, L: int, device) -> torch.Tensor:
        """Sinusoidal encodings of the offsets j - i in [-(L-1), L-1],
        ascending: (2L - 1, d_model)."""
        d_model = self.wq.shape[0]
        pos = torch.arange(-(L - 1), L, dtype=torch.float32, device=device)
        inv = 1.0 / (10000.0 ** (torch.arange(0, d_model, 2, dtype=torch.float32,
                                              device=device) / d_model))
        ang = pos[:, None] * inv[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)

    def _attn_logits(self, h, attn_mask):
        q = self._proj(h, self.wq, self.bq)
        k = self._proj(h, self.wk, self.bk)
        scale = float(np.float32(1.0) / np.sqrt(np.float32(self.d_head)))
        if self.relative:
            B, L = q.shape[0], q.shape[1]
            r = _mm(self._rel_encoding(L, h.device), self.wr).reshape(
                2 * L - 1, self.n_heads, self.d_head)
            ac = _einsum("blhd,bmhd->bhlm", q + self.u[None, None], k)
            bd_rel = _einsum("blhd,rhd->bhlr", q + self.v[None, None], r)
            # logits[..., i, j] reads offset (j - i) + L - 1
            pos = torch.arange(L, device=h.device)
            idx = (pos[None, :] - pos[:, None]) + L - 1
            bd = bd_rel.gather(-1, idx[None, None].expand(B, self.n_heads, L, L))
            logits = (ac + bd) * scale
        else:
            logits = _einsum("blhd,bmhd->bhlm", q, k) * scale
        if attn_mask is not None:
            logits = torch.where(attn_mask, logits, torch.finfo(torch.float32).min)
        return logits

    def _attention(self, h, attn_mask):
        B, L, _ = h.shape
        p = torch.softmax(self._attn_logits(h, attn_mask), dim=-1)
        v = self._proj(h, self.wv, self.bv)
        ctx = _einsum("bhlm,bmhd->blhd", p, v).reshape(B, L, -1)
        return _mm(ctx, self.wo) + self.bo

    def forward(self, x, attn_mask, *, training: bool = False, context=None):
        h = self.drop1(self._attention(self.ln1(x), attn_mask), training=training)
        x = x + h
        h = _mm(_gelu(_mm(self.ln2(x), self.w1) + self.b1), self.w2) + self.b2
        return x + self.drop2(h, training=training)

    def attention_weights(self, x, attn_mask):
        """The (B, H, L, L) softmax attention weights, recomputed from the
        layer's own projections (for ``output_attentions``)."""
        return torch.softmax(self._attn_logits(self.ln1(x), attn_mask), dim=-1)


class TransformerBlock(Block):
    """Pre-norm transformer over (B, L, D) session representations, D =
    ``in_features`` (default ``d_model``)."""

    def __init__(
        self,
        d_model: int = 64,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: Optional[int] = None,
        causal: bool = False,
        dropout: float = 0.1,
        max_seq_len: int = 512,
        share_layers: bool = False,
        relative_attention: bool = False,
        seed: int = 0,
        block_name: str = "transformer",
        output_hidden_states: bool = False,
        output_attentions: bool = False,
        in_features: Optional[int] = None,
        device=None,
    ):
        super().__init__(block_name=block_name)
        self.output_hidden_states = output_hidden_states
        self.output_attentions = output_attentions
        d_ff = d_ff or 4 * d_model
        self.d_model = d_model
        self.causal = causal
        self.share_layers = share_layers
        self.relative_attention = relative_attention
        self.n_layers = n_layers
        self.in_proj = None
        self.set_in_features(in_features or d_model, device)
        # Transformer-XL style: positions enter only through the relative
        # encodings, with no absolute table
        self.pos_emb = None if relative_attention else nn.Parameter(
            _trunc_normal((max_seq_len, d_model), 0.02, seed + 3, device))
        kw = dict(relative_attention=relative_attention, device=device)
        n_own = 1 if share_layers else n_layers
        self.layers = nn.ModuleList(
            [TransformerLayer(d_model, n_heads, d_ff, dropout, seed + i, **kw)
             for i in range(n_own)])
        self.final_ln = NNXLayerNorm(d_model, device=device)

    def set_in_features(self, in_features: int, device=None) -> None:
        """Take inputs ``in_features`` wide: a projection to ``d_model``
        (``Dense``, seed 5) where the widths differ, none where they match.
        A saved model's config replays the call."""
        record_call(self, "set_in_features", in_features, device=device)
        self.in_features = int(in_features)
        if self.in_features == self.d_model:
            self.in_proj = None
        else:
            self.in_proj = Dense(self.d_model, seed=5, in_features=self.in_features, device=device)

    def forward(self, inputs, *, training: bool = False, context=None, **kwargs):
        if isinstance(inputs, SequenceFeature):
            x, pad_mask = inputs.values, inputs.mask
        else:
            x, pad_mask = inputs, None
        if x.ndim != 3:
            raise ValueError(f"TransformerBlock expects (B, L, D) input, got {tuple(x.shape)}")
        if x.shape[-1] != self.in_features:
            raise ValueError(f"TransformerBlock takes inputs {self.in_features} wide, got "
                             f"{x.shape[-1]}: set its in_features")
        B, L, _ = x.shape
        if self.in_proj is not None:
            x = self.in_proj(x)
        if self.pos_emb is not None:
            x = x + self.pos_emb[None, :L, :]
        # (B, 1, L, L): padding on both sides, and causal
        if pad_mask is None:
            pad_mask = torch.ones(B, L, dtype=torch.bool, device=x.device)
        attn = pad_mask[:, None, None, :] & pad_mask[:, None, :, None]
        if self.causal:
            tri = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
            attn = attn & tri[None, None]
        hidden_states = [x] if self.output_hidden_states else None
        attentions = [] if self.output_attentions else None
        for i in range(self.n_layers):
            layer = self.layers[i % len(self.layers)]
            if attentions is not None:
                attentions.append(layer.attention_weights(x, attn))
            x = layer(x, attn, training=training, context=context)
            if hidden_states is not None:
                hidden_states.append(x)
        x = self.final_ln(x)
        if context is not None:
            if hidden_states is not None:
                context["hidden_states"] = hidden_states
            if attentions is not None:
                context["attentions"] = attentions
        return SequenceFeature(x, pad_mask)


# the named configurations of the JAX package (its stand-ins for the
# reference's HuggingFace wrappers)

def BertBlock(d_model=64, n_head=4, n_layer=2, **kwargs) -> TransformerBlock:
    return TransformerBlock(d_model, n_head, n_layer, causal=False, block_name="bert", **kwargs)


def RobertaBlock(d_model=64, n_head=4, n_layer=2, **kwargs) -> TransformerBlock:
    return TransformerBlock(d_model, n_head, n_layer, causal=False, block_name="roberta",
                            **kwargs)


def AlbertBlock(d_model=64, n_head=4, n_layer=2, **kwargs) -> TransformerBlock:
    return TransformerBlock(d_model, n_head, n_layer, causal=False, share_layers=True,
                            block_name="albert", **kwargs)


def XLNetBlock(d_model=64, n_head=4, n_layer=2, **kwargs) -> TransformerBlock:
    """Relative positional attention (the content stream of XLNet: the
    session role drives it with the masking transforms, as BERT)."""
    return TransformerBlock(d_model, n_head, n_layer, causal=False, relative_attention=True,
                            block_name="xlnet", **kwargs)


def GPT2Block(d_model=64, n_head=4, n_layer=2, **kwargs) -> TransformerBlock:
    return TransformerBlock(d_model, n_head, n_layer, causal=True, block_name="gpt2", **kwargs)


# output adapters

class LastHiddenState(Block):
    """The (B, L, D) hidden states as they are."""

    def forward(self, inputs, **kwargs):
        return inputs


class TransformerInferenceHiddenState(Block):
    """At inference the hidden state of each row's last valid position;
    in training everything."""

    def forward(self, inputs, *, training: bool = False, **kwargs):
        if not training and isinstance(inputs, SequenceFeature):
            return sequence_last(inputs)
        return inputs


class PoolerOutput(Block):
    """BERT's pooler: ``tanh(Dense(first position's hidden state))``, D wide."""

    def __init__(self, in_features: int, seed: int = 0, device=None):
        super().__init__()
        self.dense = Dense(in_features, activation="tanh", seed=seed, in_features=in_features,
                           device=device)

    def forward(self, inputs, **kwargs):
        v = inputs.values if isinstance(inputs, SequenceFeature) else inputs
        return self.dense(v[:, 0])


class HiddenStates(Block):
    """``{"last_hidden_state", "hidden_states"}`` from the taps of a
    ``TransformerBlock(output_hidden_states=True)``."""

    def forward(self, inputs, *, context=None, **kwargs):
        states = context.get("hidden_states") if context is not None else None
        if states is None:
            raise ValueError("No hidden states in context; build the encoder with "
                             "TransformerBlock(output_hidden_states=True)")
        return {"last_hidden_state": inputs, "hidden_states": states}


class AttentionWeights(Block):
    """``{"last_hidden_state", "attentions"}`` from the taps of a
    ``TransformerBlock(output_attentions=True)``: one (B, H, L, L) tensor a
    layer."""

    def forward(self, inputs, *, context=None, **kwargs):
        attn = context.get("attentions") if context is not None else None
        if attn is None:
            raise ValueError("No attention weights in context; build the encoder with "
                             "TransformerBlock(output_attentions=True)")
        return {"last_hidden_state": inputs, "attentions": attn}


class SequenceSummary(Block):
    """Pool the sequence: ``"last"``, ``"mean"``, or the first position
    (``"cls_index"``, ``"first"``)."""

    def __init__(self, summary: str = "last"):
        super().__init__()
        if summary not in ("last", "mean", "cls_index", "first"):
            raise ValueError(f"Unknown summary {summary!r}")
        self.summary = summary

    def forward(self, inputs, **kwargs):
        if not isinstance(inputs, SequenceFeature):
            return inputs
        if self.summary == "last":
            return sequence_last(inputs)
        if self.summary == "mean":
            return sequence_mean(inputs)
        return inputs.values[:, 0]
