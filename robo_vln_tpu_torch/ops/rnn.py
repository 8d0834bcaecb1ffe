"""Plain masked recurrences (counterpart of robo_vln_tpu/ops/rnn.py and
ops/pallas_lstm.py::_scan_impl).

Time-major: x (T, B, D), masks (T, B).  The mask of step t multiplies the
carried state *before* step t consumes its input, so a 0 resets the state at
an episode boundary.  Gate orders are torch's: LSTM (i, f, g, o), GRU (r, z,
n).  :func:`lstm_recurrence` is the version the CPU runs and the one
``ops/fused_lstm.py``'s kernel is held against on the card;
:func:`lstm_recurrence_backward` is its gradient in closed form, the plain
version of the kernel's backward.

The GRU (:func:`gru_sequence`, the flat family's ``STATE_ENCODER.rnn_type
GRU``) and the instruction encoders' length-masked recurrences
(:func:`length_masked_lstm`, :func:`length_masked_gru`) are scans in the JAX
package, not Pallas kernels, and plain PyTorch here.  The length-masked ones
take batch-major x (B, L, D) and the valid token count of each row: the
carry freezes on pad steps, outputs at pads are exactly 0 (CMA derives its
text mask from those zeros), the reverse direction skips the trailing pads,
and a row of length 0 gives zeros.  They need no lengths on the host, so a
CUDA graph can hold them.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lstm_cell(gates: torch.Tensor, c: torch.Tensor):
    """The LSTM's update from its pre-activations gates (B, 4H) = x·W_ih + b
    + h·W_hh and the carried c (B, H): (h, c)."""
    i, f, gg, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


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
        h, c = lstm_cell(gates_x[t] + h @ w_hh, c)
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


def gru_sequence(x, h0, masks, w_ih, w_hh, b_ih, b_hh):
    """Masked GRU over a sequence, torch's semantics.  x (T, B, D), h0 (B, H),
    masks (T, B), w_ih (D, 3H), w_hh (H, 3H); b_hh stays apart from b_ih, as
    the n gate needs r·(h W_hn + b_hn).  Returns (outs (T, B, H), hT)."""
    cell = _GRUCell(w_ih, w_hh, b_ih, b_hh)
    h, outs = h0, []
    for gx, m in zip(cell.gates(x), masks):
        (h,) = cell(gx, (h * m[:, None],))
        outs.append(h)
    return torch.stack(outs), h


def gru_step(x, h, mask, w_ih, w_hh, b_ih, b_hh):
    """One tick of :func:`gru_sequence`: x (B, D), mask (B,)."""
    outs, hT = gru_sequence(x[None], h, mask[None], w_ih, w_hh, b_ih, b_hh)
    return outs[0], hT


def _valid_steps(x, lengths, reverse: bool):
    """Time-major x (L, B, D) and its (L, B, 1) validity, in the order the
    direction consumes them."""
    L = x.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] < lengths.to(x.device)[:, None]
    xs, vs = x.transpose(0, 1), valid.transpose(0, 1)[..., None]
    if reverse:
        xs, vs = xs.flip(0), vs.flip(0)
    return xs, vs


def _length_masked(x, lengths, reverse, n_state, cell):
    """The scan shared by both cells: ``cell(gx_t, state) -> new state``
    (its first entry the output), the state frozen and the output 0 on pad
    steps.  Returns (outs (B, L, H), final state)."""
    xs, vs = _valid_steps(x, lengths, reverse)
    B, H = x.shape[0], cell.hidden
    state = tuple(x.new_zeros(B, H) for _ in range(n_state))
    outs = []
    for gx, v in zip(cell.gates(xs), vs):
        new = cell(gx, state)
        outs.append(torch.where(v, new[0], 0.0))
        state = tuple(torch.where(v, a, b) for a, b in zip(new, state))
    outs = torch.stack(outs)
    if reverse:
        outs = outs.flip(0)
    return outs.transpose(0, 1), state


class _LSTMCell:
    def __init__(self, w_ih, w_hh, b):
        self.w_ih, self.w_hh, self.b, self.hidden = w_ih, w_hh, b, w_hh.shape[0]

    def gates(self, xs):
        return torch.matmul(xs, self.w_ih) + self.b

    def __call__(self, gx, state):
        h, c = state
        return lstm_cell(gx + h @ self.w_hh, c)


class _GRUCell:
    def __init__(self, w_ih, w_hh, b_ih, b_hh):
        self.w_ih, self.w_hh, self.b_ih, self.b_hh = w_ih, w_hh, b_ih, b_hh
        self.hidden = w_hh.shape[0]

    def gates(self, xs):
        return torch.matmul(xs, self.w_ih) + self.b_ih

    def __call__(self, gx, state):
        (h,) = state
        xr, xz, xn = gx.chunk(3, dim=-1)
        hr, hz, hn = (h @ self.w_hh + self.b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return ((1.0 - z) * n + z * h,)


def length_masked_lstm(x, lengths, w_ih, w_hh, b, reverse: bool = False):
    """LSTM with packed-sequence semantics (the reference's
    pack_padded_sequence).  x (B, L, D), lengths (B,), w_ih (D, 4H), w_hh
    (H, 4H), b (4H,).  Returns (outs (B, L, H), (hT, cT)): the state after
    the last valid token, or with ``reverse`` after token 0."""
    outs, (h, c) = _length_masked(x, lengths, reverse, 2, _LSTMCell(w_ih, w_hh, b))
    return outs, (h, c)


def length_masked_gru(x, lengths, w_ih, w_hh, b_ih, b_hh, reverse: bool = False):
    """GRU with packed-sequence semantics (see :func:`length_masked_lstm`).
    Returns (outs (B, L, H), hT)."""
    outs, (h,) = _length_masked(x, lengths, reverse, 1, _GRUCell(w_ih, w_hh, b_ih, b_hh))
    return outs, h
