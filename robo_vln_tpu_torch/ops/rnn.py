"""Plain masked LSTM (counterpart of robo_vln_tpu/ops/rnn.py::lstm_sequence
and ops/pallas_lstm.py::_scan_impl).

Time-major: x (T, B, D), masks (T, B).  The mask of step t multiplies the
carried (h, c) *before* step t consumes its input, so a 0 resets the state at
an episode boundary.  Gate order is torch's (i, f, g, o).  This is the
version the CPU runs and the one ``ops/fused_lstm.py``'s kernel is held
against on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lstm_recurrence(
    gates_x: torch.Tensor,  # (T, B, 4H) = x·W_ih + b_ih + b_hh
    masks: torch.Tensor,  # (T, B)
    h0: torch.Tensor,  # (B, H)
    c0: torch.Tensor,  # (B, H)
    w_hh: torch.Tensor,  # (H, 4H)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrent core over a window: (outs (T, B, H), hT, cT)."""
    h, c = h0, c0
    outs = []
    for t in range(gates_x.shape[0]):
        m = masks[t][:, None]
        h = h * m
        c = c * m
        g = gates_x[t] + h @ w_hh
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs), h, c


def lstm_sequence(x, h0, c0, masks, w_ih, w_hh, b):
    """Masked LSTM over a sequence.  x (T, B, D), w_ih (D, 4H), w_hh (H, 4H),
    b (4H,) = b_ih + b_hh.  Returns (outs (T, B, H), (hT, cT))."""
    gates_x = torch.matmul(x, w_ih) + b
    outs, hT, cT = lstm_recurrence(gates_x, masks, h0, c0, w_hh)
    return outs, (hT, cT)
