"""The RCM recurrent cross-modal state encoder (counterpart of
robo_vln_tpu/models/rcm.py; the reference's RCMStateEncoder, after
arXiv 1811.10092), CMA's first state encoder with
``MODEL.CMA.rcm_state_encoder``.

At each step the previous output, masked, is the query of one single-query
attention over the rgb tokens' and one over the depth tokens' K/V (the
1×1 ``rgb_kv`` / ``depth_kv`` projections, H channels each: k the first
H/2, v the rest), and the two attended vectors with the previous-action
input feed a GRU.  The attention depends on the last output, so the
recurrence is a Python loop of cells (a ``lax.scan`` in JAX, no Pallas
there either); the K/V projections of all steps run before it as one
product.  Everything computes in float32: the logits, and the attention
weights cast to v's dtype before p·v, as in JAX.

The hidden packs (2, B, H): the GRU's h, then the last output.  Both are
multiplied by the step's mask before the step; the carry returned is
detached, as ``RNNStateEncoder`` returns it.  The GRU's parameters keep
torch's names under ``rnn`` (``weight_ih_l0`` (3H, H + A), ...), its n gate
``tanh(xn + r·(W_hn h + b_hn))`` as ``torch.nn.GRUCell`` computes it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..ops.cm_attention import single_query_attention
from ..ops.rnn import gru_step
from .hierarchical import _conv1x1, _f32
from .rnn_state_encoder import _RNNWeights


class RCMStateEncoder(nn.Module):
    num_recurrent_layers = 2  # the GRU's h and the last output

    def __init__(self, rgb_channels: int, depth_channels: int, prev_action_size: int,
                 hidden_size: int):
        super().__init__()
        H = self.hidden_size = hidden_size
        self.rgb_kv = nn.Conv1d(rgb_channels, H, 1)
        self.depth_kv = nn.Conv1d(depth_channels, H, 1)
        self.q_net = nn.Linear(H, H // 2)
        self.rnn = _RNNWeights(H + prev_action_size, H, 3)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(self.num_recurrent_layers, batch_size, self.hidden_size,
                           device=device)

    def forward(self, rgb_tokens: torch.Tensor, depth_tokens: torch.Tensor,
                prev_actions: torch.Tensor, hidden: torch.Tensor,
                masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """rgb_tokens (T, B, S_r, C_r), depth_tokens (T, B, S_d, C_d),
        prev_actions (T, B, A), hidden (2, B, H), masks (T, B).  Returns
        (outs (T, B, H), hidden (2, B, H))."""
        H = self.hidden_size
        half = H // 2
        scale = 1.0 / math.sqrt(half)
        rgb_kv = _conv1x1(rgb_tokens, self.rgb_kv)  # (T, B, S_r, H)
        depth_kv = _conv1x1(depth_tokens, self.depth_kv)
        rnn = self.rnn
        w_ih, w_hh = rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t()
        h, last = hidden[0], hidden[1]
        outs = []
        for t in range(masks.shape[0]):
            m = masks[t].float()
            q = _f32(last * m[:, None], self.q_net)
            attended = [single_query_attention(q, kv[t, ..., :half].transpose(1, 2),
                                               kv[t, ..., half:].transpose(1, 2), scale)
                        for kv in (rgb_kv, depth_kv)]
            x = torch.cat([*attended, prev_actions[t].float()], dim=1)
            last, h = gru_step(x, h, m, w_ih, w_hh, rnn.bias_ih_l0, rnn.bias_hh_l0)
            outs.append(last)
        # the carry leaves detached, as RNNStateEncoder's sequence form
        # leaves it: TBPTT windows stay independent
        return torch.stack(outs), torch.stack([h, last]).detach()
