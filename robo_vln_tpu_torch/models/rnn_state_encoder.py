"""Recurrent state encoder with the packed-hidden API (counterpart of
robo_vln_tpu/models/rnn_state_encoder.py).

The hidden state is packed as one (layers, B, H) tensor, as the reference's
RNNStateEncoder does: an LSTM's [h; c] stacked on the first axis (2, B, H),
a GRU's h alone (1, B, H).  The parameters keep torch's names under ``.rnn``
(``weight_ih_l0`` (gates·H, D), ``weight_hh_l0`` (gates·H, H),
``bias_ih_l0``, ``bias_hh_l0``), so a reference state_dict loads as it is;
the forward never calls cuDNN.  Both the single-step form (x (B, D), masks
(B,)) and the sequence form (x (T, B, D), masks (T, B)) of an LSTM go
through ``ops/fused_lstm.lstm_sequence_fused`` with bias b_ih + b_hh; a GRU
runs the plain ``ops/rnn.gru_sequence`` (a scan in JAX, no kernel).  The
sequence form detaches the returned carry, as the reference does, which is
what makes TBPTT windows independent.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..ops import fused_lstm
from ..ops.rnn import gru_sequence

GATES = {"LSTM": 4, "GRU": 3}


class _RNNWeights(nn.Module):
    """The parameters of a one-layer ``nn.LSTM`` or ``nn.GRU``, under its
    key names."""

    def __init__(self, input_size: int, hidden_size: int, gates: int):
        super().__init__()
        n = gates * hidden_size
        self.weight_ih_l0 = nn.Parameter(torch.empty(n, input_size))
        self.weight_hh_l0 = nn.Parameter(torch.empty(n, hidden_size))
        self.bias_ih_l0 = nn.Parameter(torch.zeros(n))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(n))


class RNNStateEncoder(nn.Module):
    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "LSTM"):
        super().__init__()
        if rnn_type not in GATES:
            raise ValueError(f"rnn_type {rnn_type!r}: the state encoder is an LSTM or a GRU")
        self.hidden_size = hidden_size
        self.rnn_type = rnn_type
        self.rnn = _RNNWeights(input_size, hidden_size, GATES[rnn_type])

    @property
    def num_recurrent_layers(self) -> int:
        return 2 if self.rnn_type == "LSTM" else 1

    def initial_hidden(self, batch_size: int, device=None) -> torch.Tensor:
        return torch.zeros(self.num_recurrent_layers, batch_size, self.hidden_size,
                           device=device)

    def forward(self, x: torch.Tensor, hidden: torch.Tensor,
                masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        single = x.dim() == 2
        if single:
            x, masks = x[None], masks[None]
        rnn = self.rnn
        if self.rnn_type == "LSTM":
            outs, (hT, cT) = fused_lstm.lstm_sequence_fused(
                x.float(), hidden[0], hidden[1], masks.float(),
                rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t(),
                rnn.bias_ih_l0 + rnn.bias_hh_l0,
            )
            new_hidden = torch.stack([hT, cT], dim=0)
        else:
            outs, hT = gru_sequence(x.float(), hidden[0], masks.float(),
                                    rnn.weight_ih_l0.t(), rnn.weight_hh_l0.t(),
                                    rnn.bias_ih_l0, rnn.bias_hh_l0)
            new_hidden = hT[None]
        if single:
            return outs[0], new_hidden
        return outs, new_hidden.detach()
