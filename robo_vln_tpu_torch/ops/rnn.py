"""Plain masked LSTM (counterpart of robo_vln_tpu/ops/rnn.py::lstm_sequence
and ops/pallas_lstm.py::_scan_impl).

Time-major: x (T, B, D), masks (T, B).  The mask of step t multiplies the
carried (h, c) *before* step t consumes its input, so a 0 resets the state at
an episode boundary.  Gate order is torch's (i, f, g, o).  This is the
version the CPU runs and the one ``ops/fused_lstm.py``'s kernel is held
against on the card.  :func:`lstm_recurrence_backward` is its gradient in
closed form, the plain version of the kernel's backward.
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


def lstm_recurrence_backward(
    gates_x, masks, h0, c0, w_hh,  # lstm_recurrence's inputs
    outs: torch.Tensor,  # (T, B, H): its first output
    g_outs: torch.Tensor,  # (T, B, H)
    g_hT: torch.Tensor,  # (B, H)
    g_cT: torch.Tensor,  # (B, H)
    masks_grad: bool = True,
):
    """The VJP of :func:`lstm_recurrence` at the cotangents (g_outs, g_hT,
    g_cT), written out, with no autograd: (d_gates_x, d_masks, d_h0, d_c0,
    d_w_hh), d_masks None unless ``masks_grad``.  With h~_t = m_t h_{t-1},
    c~_t = m_t c_{t-1} and the gates g_t = gx_t + h~_t W recomputed in one
    product, from t = T-1 down to 0:
    dh = g_outs[t] + m_{t+1} dh~_{t+1}, dc = m_{t+1} dc~_{t+1} + dh o (1 - tanh² c_t),
    dg = (dc gg i(1-i), dc c~ f(1-f), dc i (1-gg²), dh tanh(c_t) o(1-o)),
    dh~_t = dg W^T, dc~_t = dc f, d_masks[t] = Σ_H (h_{t-1} dh~_t + c_{t-1} dc~_t),
    d_W = Σ_t h~_t^T dg_t."""
    T, B, four_h = gates_x.shape
    H = four_h // 4
    m = masks[..., None]
    h_prev = torch.cat([h0[None], outs[:-1]])
    h_tilde = h_prev * m
    i, f, gg, o = (gates_x + h_tilde @ w_hh).chunk(4, dim=-1)
    i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
    cs, c = [], c0
    for t in range(T):
        c = f[t] * (c * m[t]) + i[t] * gg[t]
        cs.append(c)
    c_prev = [c0] + cs[:-1]
    d_gates = torch.empty_like(gates_x)
    d_masks = torch.empty_like(masks) if masks_grad else None
    dh_carry, dc_carry = g_hT, g_cT
    for t in reversed(range(T)):
        tc = torch.tanh(cs[t])
        dh = g_outs[t] + dh_carry
        dc = dc_carry + dh * o[t] * (1 - tc * tc)
        dg = torch.cat([dc * gg[t] * i[t] * (1 - i[t]),
                        dc * (c_prev[t] * m[t]) * f[t] * (1 - f[t]),
                        dc * i[t] * (1 - gg[t] * gg[t]),
                        dh * tc * o[t] * (1 - o[t])], dim=-1)
        d_gates[t] = dg
        dh_tilde = dg @ w_hh.t()
        dc_tilde = dc * f[t]
        if masks_grad:
            d_masks[t] = (h_prev[t] * dh_tilde + c_prev[t] * dc_tilde).sum(-1)
        dh_carry, dc_carry = dh_tilde * m[t], dc_tilde * m[t]
    d_w_hh = h_tilde.reshape(T * B, H).t() @ d_gates.reshape(T * B, four_h)
    return d_gates, d_masks, dh_carry, dc_carry, d_w_hh


def lstm_sequence(x, h0, c0, masks, w_ih, w_hh, b):
    """Masked LSTM over a sequence.  x (T, B, D), w_ih (D, 4H), w_hh (H, 4H),
    b (4H,) = b_ih + b_hh.  Returns (outs (T, B, H), (hT, cT))."""
    gates_x = torch.matmul(x, w_ih) + b
    outs, hT, cT = lstm_recurrence(gates_x, masks, h0, c0, w_hh)
    return outs, (hT, cT)
