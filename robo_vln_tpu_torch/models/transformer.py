"""Cross-modal transformer blocks (counterpart of
robo_vln_tpu/models/transformer.py:35-177).

* :class:`MultiHeadAttention` — Q/K/V/O linears around
  ``ops/cm_attention.attention_core``, post-LN residual; with
  ``cm_attention.set_sow_attention`` on (PLOT_ATTENTION) it also sows its
  softmax weights, computed beside the output for the plot only;
* :class:`PositionWiseFeedForward` — ReLU MLP, post-LN residual;
* :class:`InterModuleAttnLayer` — cross-attention + FFN;
* :class:`VisualLingAttn` — instruction queries × visual keys/values, the HCM
  agent's core block: ONE LayerNorm serves both streams, and the sinusoid
  position table is added to the queries only.

The linears run in the compute dtype (bfloat16 by default); LayerNorms run in
float32 with flax's eps=1e-6 (torch's default is 1e-5).  Parameter names
follow the reference's torch modules (``enc_att.attention.fc_q``,
``pwff.fc1``, ...).

Dropout sits where the JAX blocks put it: after ``fc_o`` before the residual,
after the feed-forward's ReLU and after its ``fc2``, and after each input
stage's ReLU in :class:`VisualLingAttn`, at the rate VisualLingAttn passes
down.  It is live only in training mode (``module.train()``) and when the
forward is given a ``torch.Generator`` to draw the masks from (on the
tensors' device); otherwise it is the identity, so eval and serving compute
exactly what they computed without it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cm_attention
from ..ops.cm_attention import attention_core

LN_EPS = 1e-6  # flax nn.LayerNorm default


def sinusoid_encoding_table(max_len: int, d_model: int, device=None) -> torch.Tensor:
    """Sin (even columns) / cos (odd columns), pair k at frequency
    10000^(2k/d), float32."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)[None, :]
    # a Python scalar base: no host-to-device copy, so a CUDA graph captures it
    angle = pos / torch.pow(10000.0, 2.0 * dim / d_model)
    out = torch.zeros(max_len, d_model, dtype=torch.float32, device=device)
    out[:, 0::2] = torch.sin(angle)
    out[:, 1::2] = torch.cos(angle)
    return out


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``, as a flax Dense with that dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dropout(x: torch.Tensor, rate: float, generator, training: bool) -> torch.Tensor:
    """flax's Dropout: each element kept with probability 1 - rate and then
    scaled by 1 / (1 - rate), else zeroed; the keep mask drawn from
    ``generator`` (``F.dropout`` takes none).  The identity outside training,
    without a generator, or at rate 0."""
    if not training or generator is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, device=x.device).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), 0.0)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class _ScaledDotProductAttention(nn.Module):
    """Holds the reference's fc_q/fc_k/fc_v/fc_o under ``.attention``."""

    def __init__(self, d_model: int, h: int):
        super().__init__()
        d_k = d_model // h
        self.fc_q = nn.Linear(d_model, h * d_k)
        self.fc_k = nn.Linear(d_model, h * d_k)
        self.fc_v = nn.Linear(d_model, h * d_k)
        self.fc_o = nn.Linear(h * d_k, d_model)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, h: int, compute_dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.h = h
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.attention = _ScaledDotProductAttention(d_model, h)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, queries, keys, values, attention_mask=None, generator=None):
        a, dt = self.attention, self.compute_dtype
        q = linear(queries, a.fc_q, dt)
        k = linear(keys, a.fc_k, dt)
        v = linear(values, a.fc_v, dt)
        out = attention_core(q, k, v, self.h, attention_mask)
        if cm_attention.sow_attention():  # PLOT_ATTENTION: the maps, for the plot only
            cm_attention.sow(cm_attention.attention_weights(q, k, self.h, attention_mask))
        out = dropout(linear(out, a.fc_o, dt), self.dropout, generator, self.training)
        return layer_norm(queries.float() + out.float(), self.layer_norm)


class PositionWiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, compute_dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, generator=None):
        dt, rate, live = self.compute_dtype, self.dropout, self.training
        y = dropout(F.relu(linear(x, self.fc1, dt)), rate, generator, live)
        y = dropout(linear(y, self.fc2, dt), rate, generator, live)
        return layer_norm(x.float() + y.float(), self.layer_norm)


class InterModuleAttnLayer(nn.Module):
    def __init__(self, d_model: int, h: int, d_ff: int, compute_dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.enc_att = MultiHeadAttention(d_model, h, compute_dtype, dropout)
        self.pwff = PositionWiseFeedForward(d_model, d_ff, compute_dtype, dropout)

    def forward(self, input_1, input_2, enc_att_mask=None, generator=None):
        att = self.enc_att(input_1, input_2, input_2, enc_att_mask, generator)
        return self.pwff(att, generator)


class VisualLingAttn(nn.Module):
    """instruction (N, L, ins_in_features) queries × visual (N, S,
    vis_in_features) tokens -> (N, L, d_model)."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int,
                 vis_in_features: int, ins_in_features: int,
                 compute_dtype=torch.float32, dropout: float = 0.25):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.layers = nn.ModuleList(
            InterModuleAttnLayer(d_model, h, d_ff, compute_dtype, dropout)
            for _ in range(n_layers)
        )
        self.vis_fc = nn.Linear(vis_in_features, d_model)
        self.ins_fc = nn.Linear(ins_in_features, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, instruction, visual, enc_att_mask=None, generator=None):
        dt, rate, live = self.compute_dtype, self.dropout, self.training
        vis = dropout(F.relu(linear(visual, self.vis_fc, dt)), rate, generator, live)
        vis = layer_norm(vis, self.layer_norm)
        ins = dropout(F.relu(linear(instruction, self.ins_fc, dt)), rate, generator, live)
        ins = layer_norm(ins, self.layer_norm)
        ins = ins + sinusoid_encoding_table(ins.shape[1], ins.shape[2], ins.device)
        out = vis
        for layer in self.layers:
            out = layer(ins, out, enc_att_mask, generator)
        return out
