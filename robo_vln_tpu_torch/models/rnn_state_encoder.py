"""Recurrent state encoder with the packed-hidden API (counterpart of
robo_vln_tpu/models/rnn_state_encoder.py).

The hidden state is packed as one (2, B, H) tensor, [h; c] stacked on the
first axis, as the reference's RNNStateEncoder does.  The LSTM's parameters
keep torch's names under ``.rnn`` (``weight_ih_l0`` (4H, D), ``weight_hh_l0``
(4H, H), ``bias_ih_l0``, ``bias_hh_l0``), so a reference state_dict loads as
it is; the forward never calls cuDNN.  Both the single-step form (x (B, D),
masks (B,)) and the sequence form (x (T, B, D), masks (T, B)) go through
``ops/fused_lstm.lstm_sequence_fused`` with bias b_ih + b_hh, and the
sequence form detaches the returned carry, as the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import fused_lstm


class _LSTMWeights(nn.Module):
    """The parameters of a one-layer ``nn.LSTM``, under its key names."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        four_h = 4 * hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(four_h, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(four_h, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(four_h))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(four_h))


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "LSTM"):
        super().__init__()
        if rnn_type != "LSTM":
            raise NotImplementedError("the HCM agent's state encoders are LSTMs")
        self.hidden_size = hidden_size
        self.rnn = _LSTMWeights(input_size, hidden_size)

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(2, batch_size, self.hidden_size, device=device)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor,
                masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        single = x.dim() == 2
        if single:
            x, masks = x[None], masks[None]
        rnn = self.rnn
        outs, (hT, cT) = fused_lstm.lstm_sequence_fused(
            x.float(), hidden[0], hidden[1], masks.float(),
            rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t(),
            rnn.bias_ih_l0 + rnn.bias_hh_l0,
        )
        new_hidden = torch.stack([hT, cT], dim=0)
        if single:
            return outs[0], new_hidden
        return outs, new_hidden.detach()
