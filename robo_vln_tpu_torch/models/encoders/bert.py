"""BERT encoder, the HCM agent's frozen instruction embedder (counterpart of
robo_vln_tpu/models/encoders/bert.py).

Standard BERT: word + position + token-type embeddings and LayerNorm, then
post-LN layers with exact-erf GELU, all LayerNorms eps=1e-12 in float32.  Two
reference quirks are kept: there is no attention mask (pad tokens are
attended) and the token type is always 0.  Self-attention is the plain
``ops/cm_attention.mha_attention``, never the cross-modal kernel, as in JAX.
Parameter names follow HuggingFace's ``BertModel`` (``embeddings.*``,
``encoder.layer.N.attention.self.query.weight`` ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cm_attention import mha_attention
from ..transformer import layer_norm, linear

BERT_LN_EPS = 1e-12


class _SelfAttention(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _DenseLN(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.dense = nn.Linear(i, o)
        self.LayerNorm = nn.LayerNorm(o, eps=BERT_LN_EPS)


class _Attention(nn.Module):
    def __init__(self, hidden):
        super().__init__()
        self.self = _SelfAttention(hidden)
        self.output = _DenseLN(hidden, hidden)


class _Intermediate(nn.Module):
    def __init__(self, hidden, inter):
        super().__init__()
        self.dense = nn.Linear(hidden, inter)


class BertLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.attention = _Attention(hidden_size)
        self.intermediate = _Intermediate(hidden_size, intermediate_size)
        self.output = _DenseLN(intermediate_size, hidden_size)

    def forward(self, x):
        dt, sa = self.compute_dtype, self.attention.self
        q, k, v = linear(x, sa.query, dt), linear(x, sa.key, dt), linear(x, sa.value, dt)
        att = mha_attention(q, k, v, self.num_heads)
        att = linear(att, self.attention.output.dense, dt)
        x = layer_norm(x.float() + att.float(), self.attention.output.LayerNorm)
        y = F.gelu(linear(x, self.intermediate.dense, dt))
        y = linear(y, self.output.dense, dt)
        return layer_norm(x.float() + y.float(), self.output.LayerNorm)


class _Embeddings(nn.Module):
    def __init__(self, vocab, hidden, max_pos, type_vocab):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab, hidden)
        self.position_embeddings = nn.Embedding(max_pos, hidden)
        self.token_type_embeddings = nn.Embedding(type_vocab, hidden)
        self.LayerNorm = nn.LayerNorm(hidden, eps=BERT_LN_EPS)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layer = nn.ModuleList(layers)


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position_embeddings: int = 512,
                 type_vocab_size: int = 2, compute_dtype=torch.float32):
        super().__init__()
        self.embeddings = _Embeddings(
            vocab_size, hidden_size, max_position_embeddings, type_vocab_size
        )
        self.encoder = _Encoder(
            BertLayer(hidden_size, num_heads, intermediate_size, compute_dtype)
            for _ in range(num_layers)
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """input_ids (B, L) -> last hidden state (B, L, hidden), float32."""
        e = self.embeddings
        L = input_ids.shape[1]
        x = (e.word_embeddings(input_ids.long())
             + e.position_embeddings.weight[:L][None]
             + e.token_type_embeddings.weight[0][None, None])
        x = layer_norm(x, e.LayerNorm)
        for layer in self.encoder.layer:
            x = layer(x)
        return x
