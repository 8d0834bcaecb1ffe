"""Cross-modal transformer blocks (counterpart of
robo_vln_tpu/models/transformer.py).

* :class:`MultiHeadAttention` — Q/K/V/O linears around
  ``ops/cm_attention.attention_core``, post-LN residual; with
  ``cm_attention.set_sow_attention`` on (PLOT_ATTENTION) it also sows its
  softmax weights, computed beside the output for the plot only;
* :class:`PositionWiseFeedForward` — ReLU MLP, post-LN residual;
* :class:`InterModuleAttnLayer` — cross-attention + FFN;
* :class:`VisualLingAttn` — instruction queries × visual keys/values, the HCM
  agent's core block: ONE LayerNorm serves both streams, and the sinusoid
  position table is added to the queries only;
* the rest of the reference's stack, which no policy builds:
  :class:`EncoderLayer`, :class:`BaseEncoder`,
  :class:`TransformerLanguageEncoder`, :class:`DecoderLayer`,
  :class:`InterModuleAttnDecoder`, :class:`ImageCrossModalEncoder`,
  :class:`PositionEmbedding2DLearned`, :class:`ImageEncoderWithPosEncodings`
  and :class:`ImagePlainEncoder`.

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

import functools

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


# -- the rest of the reference's transformer stack: no policy or yaml builds
# these (nor in the JAX package); each keeps its JAX block's arithmetic and
# the reference's parameter names, and sends every attention call through
# attention_core (unmasked: the kernel on the card; masked: the plain path)


def _input_stage(x, fc: nn.Linear, ln: nn.LayerNorm, dt, rate, generator, live):
    """Linear -> ReLU -> dropout -> LayerNorm (float32 out)."""
    return layer_norm(dropout(F.relu(linear(x, fc, dt)), rate, generator, live), ln)


class EncoderLayer(nn.Module):
    """Self-attention + FFN."""

    def __init__(self, d_model: int, h: int, d_ff: int, compute_dtype=torch.float32,
                 dropout: float = 0.1):
        super().__init__()
        self.mhatt = MultiHeadAttention(d_model, h, compute_dtype, dropout)
        self.pwff = PositionWiseFeedForward(d_model, d_ff, compute_dtype, dropout)

    def forward(self, queries, keys, values, attention_mask=None, generator=None):
        att = self.mhatt(queries, keys, values, attention_mask, generator)
        return self.pwff(att, generator)


class BaseEncoder(nn.Module):
    """A stack of self-attention EncoderLayers."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int,
                 compute_dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, h, d_ff, compute_dtype, dropout) for _ in range(n_layers))

    def forward(self, x, attention_mask=None, generator=None):
        out = x
        for layer in self.layers:
            out = layer(out, out, out, attention_mask, generator)
        return out


class TransformerLanguageEncoder(nn.Module):
    """Linear -> ReLU -> LN input stage, the sinusoid table added (zero at
    pads: ``pad_mask`` (B, L, 1) bool, True = pad), then N self-attention
    layers."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int, d_in: int,
                 compute_dtype=torch.float32, dropout: float = 0.2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.fc = nn.Linear(d_in, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.encoder = BaseEncoder(d_model, h, d_ff, n_layers, compute_dtype, dropout)

    def forward(self, x, pad_mask=None, attention_mask=None, generator=None):
        out = _input_stage(x, self.fc, self.layer_norm, self.compute_dtype, self.dropout,
                           generator, self.training)
        pe = sinusoid_encoding_table(out.shape[1], out.shape[2], out.device)[None]
        if pad_mask is not None:
            pe = torch.where(pad_mask, 0.0, pe)
        return self.encoder(out + pe, attention_mask, generator)


class DecoderLayer(nn.Module):
    """Self-attention (``pos_embed`` added to its input and output), an
    optional adaptive average pool over the tokens to ``pool_to`` (the
    reference's ``pooler``), cross-attention onto ``enc_output``, FFN."""

    def __init__(self, d_model: int, h: int, d_ff: int, compute_dtype=torch.float32,
                 dropout: float = 0.1, pool_to: int = 0):
        super().__init__()
        self.pool_to = pool_to
        self.self_att = MultiHeadAttention(d_model, h, compute_dtype, dropout)
        self.enc_att = MultiHeadAttention(d_model, h, compute_dtype, dropout)
        self.pwff = PositionWiseFeedForward(d_model, d_ff, compute_dtype, dropout)

    def forward(self, x, enc_output, mask_self_att=None, mask_enc_att=None, pos_embed=None,
                generator=None):
        if pos_embed is not None:
            x = x + pos_embed
        self_att = self.self_att(x, x, x, mask_self_att, generator)
        if pos_embed is not None:
            self_att = self_att + pos_embed
        if self.pool_to:
            self_att = F.adaptive_avg_pool1d(self_att.transpose(1, 2),
                                             self.pool_to).transpose(1, 2)
        enc_att = self.enc_att(self_att, enc_output, enc_output, mask_enc_att, generator)
        return self.pwff(enc_att, generator)


class InterModuleAttnDecoder(nn.Module):
    """One Linear -> ReLU -> LN input stage shared by both streams, then N
    cross-attention layers of ``input_1`` onto ``input_2``."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int, in_features: int,
                 compute_dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.fc = nn.Linear(in_features, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.layers = nn.ModuleList(
            InterModuleAttnLayer(d_model, h, d_ff, compute_dtype, dropout)
            for _ in range(n_layers))

    def forward(self, input_1, input_2, self_att_mask=None, enc_att_mask=None, generator=None):
        stage = functools.partial(_input_stage, fc=self.fc, ln=self.layer_norm,
                                  dt=self.compute_dtype, rate=self.dropout,
                                  generator=generator, live=self.training)
        out, inp2 = stage(input_1), stage(input_2)
        for layer in self.layers:
            out = layer(out, inp2, enc_att_mask, generator)
        return out


class ImageCrossModalEncoder(nn.Module):
    """Linear -> ReLU -> LN input stage, then N DecoderLayers onto
    ``enc_output``."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int, in_features: int,
                 compute_dtype=torch.float32, dropout: float = 0.2):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.fc = nn.Linear(in_features, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, h, d_ff, compute_dtype, dropout) for _ in range(n_layers))

    def forward(self, x, enc_output, self_att_mask=None, enc_att_mask=None, generator=None):
        out = _input_stage(x, self.fc, self.layer_norm, self.compute_dtype, self.dropout,
                           generator, self.training)
        for layer in self.layers:
            out = layer(out, enc_output, self_att_mask, enc_att_mask, generator=generator)
        return out


class PositionEmbedding2DLearned(nn.Module):
    """Learned absolute 2D position embedding of an h × w feature map:
    (B, h, w, 2·num_pos_feats), the column's embedding then the row's."""

    def __init__(self, num_pos_feats: int = 128, max_size: int = 50):
        super().__init__()
        self.row_embed = nn.Embedding(max_size, num_pos_feats)
        self.col_embed = nn.Embedding(max_size, num_pos_feats)
        nn.init.uniform_(self.row_embed.weight)
        nn.init.uniform_(self.col_embed.weight)

    def forward(self, feature_map_hw, batch: int):
        h, w = feature_map_hw
        f = self.row_embed.weight.shape[1]
        x_emb = self.col_embed.weight[None, :w].expand(h, w, f)
        y_emb = self.row_embed.weight[:h, None].expand(h, w, f)
        return torch.cat([x_emb, y_emb], dim=-1)[None].expand(batch, h, w, 2 * f)


class ImageEncoderWithPosEncodings(nn.Module):
    """Dropout -> LN input stage, then N DecoderLayers with ``pos_embed``
    added to their queries.  The reference also builds an ``fc`` that its
    forward never uses; as in the JAX package, there is none."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int, d_in: int,
                 compute_dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, h, d_ff, compute_dtype, dropout) for _ in range(n_layers))

    def forward(self, x, enc_output, self_att_mask=None, enc_att_mask=None, pos_embed=None,
                generator=None):
        out = layer_norm(dropout(x, self.dropout, generator, self.training), self.layer_norm)
        for layer in self.layers:
            out = layer(out, enc_output, self_att_mask, enc_att_mask, pos_embed, generator)
        return out


class ImagePlainEncoder(nn.Module):
    """Linear -> ReLU -> dropout -> LN input stage, then N self-attention
    layers (the reference's __init__ cannot be built as shipped; this is its
    intended block, as in the JAX package)."""

    def __init__(self, d_model: int, h: int, d_ff: int, n_layers: int, d_in: int,
                 compute_dtype=torch.float32, dropout: float = 0.1):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        self.fc = nn.Linear(d_in, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.encoder = BaseEncoder(d_model, h, d_ff, n_layers, compute_dtype, dropout)

    def forward(self, x, attention_mask=None, generator=None):
        out = _input_stage(x, self.fc, self.layer_norm, self.compute_dtype, self.dropout,
                           generator, self.training)
        return self.encoder(out, attention_mask, generator)
