"""The masked LSTM's backward against the JAX package's custom VJP
(robo_vln_tpu/ops/pallas_lstm.py::fused_lstm_sequence, whose _bwd
differentiates its scan; on the CPU its forward is the scan too).

Inputs, masks (odd rows reset at t=0, the last row reset mid-window) and
cotangents are made from a seed with numpy and handed to both sides.  W_hh
is scaled by H^-1/2, as chip_smoke.py scales it.  Tolerances, float32 on
both sides: each of the five gradients (gates_x, masks, h0, c0, w_hh)
within 1e-5 of that gradient's norm, the largest element's error against
the norm of the whole gradient, since the reverse sums over 50 steps and
over 4H run in another order than XLA's.

* :func:`ops.rnn.lstm_recurrence_backward`, the plain version;
* an emulation of csrc/lstm_seq.cu's backward kernel in plain float32
  torch (the c_t sweep, the dg exchange, each lane's chunks of the 4H dot
  product and the xor tree over the lanes), run inside the wrapper's own
  :func:`ops.fused_lstm.reverse_pass`;
* batch slices, joined, against the whole batch;
* the backward's shape predicate and shared-memory formula, its C entry's
  set-up, and ``_FusedLSTM`` with stand-ins for both launches, its weight a
  transposed bfloat16 view.  The kernel itself runs only on the card:
  chip_smoke.py holds it against the plain version there.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.ops import pallas_lstm as jax_lstm
from robo_vln_tpu_torch.ops import _build, fused_lstm
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
from tests.test_torch_ops import _lstm_kernel_emulation

REL_TOL = 1e-5
SHAPES = [(50, 4, 512), (7, 11, 64), (3, 9, 32), (4, 3, 556), (1, 8, 512)]


def _inputs(rng, T, B, H):
    """(gates_x, masks, h0, c0, w_hh) and the cotangents (g_outs, g_hT,
    g_cT), numpy float32."""
    masks = np.ones((T, B), np.float32)
    masks[0, 1::2] = 0.0
    if T > 2:
        masks[T // 2, B - 1] = 0.0
    args = (rng.standard_normal((T, B, 4 * H)).astype(np.float32), masks,
            rng.standard_normal((B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32),
            (rng.standard_normal((H, 4 * H)) * H ** -0.5).astype(np.float32))
    cots = (rng.standard_normal((T, B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))
    return args, cots


def _jax_vjp(args, cots):
    _, vjp = jax.vjp(jax_lstm.fused_lstm_sequence, *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cots)))]


def _assert_rel(got, want, what):
    names = ("gates_x", "masks", "h0", "c0", "w_hh")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        err = np.abs(np.asarray(g, np.float32) - w).max()
        assert err <= REL_TOL * max(np.linalg.norm(w), 1e-30), f"{what} d_{name}: {err}"


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _tanh(x):
    return 1.0 - 2.0 / (torch.exp(2.0 * x) + 1.0)


def _backward_kernel_emulation(gates, masks, c0, w_rows, g_outs, g_hT, g_cT, masks_grad):
    """csrc/lstm_seq.cu's lstm_seq_backward_kernel over one launch's rows,
    in plain float32 torch, with the launch's outputs (d_gates, d_h0, d_c0,
    c_t, dh~, dc~).  The owner of each cell sweeps c_t forward; then, from
    t = T-1, the cell update gives dg_t, which crosses to every block as it
    is (the exchange moves float bits), and dh~_t of unit v is formed as
    the kernel forms it: lane l sums, chunk j by chunk j (k = 128·j + 4·l +
    i) and within a chunk gate by gate, the four values of its 16-byte
    chunk of each gate segment of dg_t times W_hh[v, :]; an xor-shuffle
    tree (offsets 16, 8, 4, 2, 1) sums the lanes.  The activations are
    written through exp, as the kernel writes them."""
    T, B, four_h = gates.shape
    H = four_h // 4
    k_pad = -(-H // 128) * 128  # chunks past H are a lane's zeros
    kc = k_pad // 128
    w = torch.zeros(H, 4, k_pad)
    w[:, :, :H] = w_rows.view(H, 4, H)
    w = w.view(H, 4, kc, 32, 4)
    lanes = torch.arange(32)

    def dot(dg):
        d = torch.zeros(B, 4, k_pad)
        d[:, :, :H] = dg.view(B, 4, H)
        d = d.view(B, 4, kc, 32, 4)
        acc = torch.zeros(B, 32, H)
        for j in range(kc):
            for gate in range(4):
                for i in range(4):
                    acc = acc + d[:, gate, j, :, i, None] * w[:, gate, j, :, i].t()[None]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        return acc[:, 0]

    c, cs = c0, []
    for t in range(T):
        gi, gf, gg = gates[t, :, :H], gates[t, :, H:2 * H], gates[t, :, 2 * H:3 * H]
        c = _sigmoid(gf) * (c * masks[t, :, None]) + _sigmoid(gi) * _tanh(gg)
        cs.append(c)
    d_gates, d_h_tilde, d_c_tilde = (torch.zeros(T, B, four_h), torch.zeros(T, B, H),
                                     torch.zeros(T, B, H))
    dh_carry, dc_carry, dc_tilde, dg_prev = g_hT, g_cT, None, None
    for s in range(T + 1):
        t = T - 1 - s
        if s > 0:
            dht = dot(dg_prev)
            d_h_tilde[t + 1] = dht
            m_next = masks[t + 1, :, None]
            dh_carry, dc_carry = m_next * dht, m_next * dc_tilde
        if s == T:
            break
        m = masks[t, :, None]
        ig, fg = _sigmoid(gates[t, :, :H]), _sigmoid(gates[t, :, H:2 * H])
        gg, og = _tanh(gates[t, :, 2 * H:3 * H]), _sigmoid(gates[t, :, 3 * H:])
        c_prev = cs[t - 1] if t > 0 else c0
        tc = _tanh(cs[t])
        dh = g_outs[t] + dh_carry
        dc = dc_carry + dh * og * (1.0 - tc * tc)
        dg_prev = torch.cat([dc * gg * ig * (1.0 - ig), dc * (c_prev * m) * fg * (1.0 - fg),
                             dc * ig * (1.0 - gg * gg), dh * tc * og * (1.0 - og)], dim=-1)
        d_gates[t] = dg_prev
        dc_tilde = dc * fg
        d_c_tilde[t] = dc_tilde
    if not masks_grad:
        d_h_tilde = d_c_tilde = None
    return d_gates, dh_carry, dc_carry, torch.stack(cs), d_h_tilde, d_c_tilde


@pytest.mark.parametrize("T,B,H", SHAPES)
def test_lstm_recurrence_backward_matches_jax_vjp(rng, T, B, H):
    """The plain backward, from the plain forward's outs, against the JAX
    custom VJP: all five gradients, the masks' included."""
    args, cots = _inputs(rng, T, B, H)
    targs = list(map(torch.from_numpy, args))
    outs = lstm_recurrence(*targs)[0]
    got = lstm_recurrence_backward(*targs, outs, *map(torch.from_numpy, cots))
    _assert_rel(got, _jax_vjp(args, cots), f"T={T} B={B} H={H}")


def test_lstm_recurrence_backward_masks_gradient_only_when_asked(rng):
    args, cots = _inputs(rng, 5, 3, 16)
    targs = list(map(torch.from_numpy, args))
    outs = lstm_recurrence(*targs)[0]
    both = [lstm_recurrence_backward(*targs, outs, *map(torch.from_numpy, cots),
                                     masks_grad=flag) for flag in (True, False)]
    assert both[0][1] is not None and both[1][1] is None
    for g, r in zip(both[1], both[0]):
        if g is not None:
            torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("T,B,H", SHAPES[:4])
def test_lstm_backward_kernel_summation_order_matches_jax(rng, T, B, H):
    """The kernel's order of operations, inside the wrapper's reverse_pass
    and from the forward kernel's emulated outs, against the JAX VJP (H =
    556: a partial last chunk of lanes and a ragged grid)."""
    args, cots = _inputs(rng, T, B, H)
    targs = list(map(torch.from_numpy, args))
    outs = _lstm_kernel_emulation(*targs)[0]
    got = fused_lstm.reverse_pass(_backward_kernel_emulation, [(0, B)], *targs, outs,
                                  *map(torch.from_numpy, cots), True)
    _assert_rel(got, _jax_vjp(args, cots), f"T={T} B={B} H={H}")


def test_lstm_backward_batch_slices_join(rng):
    """Rows run in slices: reverse_pass joins d_gates_x, d_masks, d_h0 and
    d_c0 along rows and forms d_w_hh once from the joined rows, so the
    result is the whole batch's, bit for bit.  The plain backward run on
    each slice, joined and with d_w_hh summed over the slices, gives the
    whole batch's within the tolerance, and the JAX VJP's."""
    T, B, H = 6, 7, 32
    args, cots = _inputs(rng, T, B, H)
    targs = list(map(torch.from_numpy, args))
    tcots = list(map(torch.from_numpy, cots))
    outs = _lstm_kernel_emulation(*targs)[0]
    whole = fused_lstm.reverse_pass(_backward_kernel_emulation, [(0, B)], *targs, outs,
                                    *tcots, True)
    sliced = fused_lstm.reverse_pass(_backward_kernel_emulation, [(0, 3), (3, 6), (6, 7)],
                                     *targs, outs, *tcots, True)
    for s, w in zip(sliced, whole):
        torch.testing.assert_close(s, w, atol=0, rtol=0)

    gates_x, masks, h0, c0, w_hh = targs
    g_outs, g_hT, g_cT = tcots
    parts = [lstm_recurrence_backward(gates_x[:, b0:b1], masks[:, b0:b1], h0[b0:b1],
                                      c0[b0:b1], w_hh, outs[:, b0:b1], g_outs[:, b0:b1],
                                      g_hT[b0:b1], g_cT[b0:b1])
             for b0, b1 in ((0, 3), (3, 6), (6, 7))]
    joined = [torch.cat([p[k] for p in parts], dim=dim) for k, dim in enumerate((1, 1, 0, 0))]
    joined.append(sum(p[4] for p in parts))
    plain = lstm_recurrence_backward(*targs, outs, *tcots)
    _assert_rel(joined, plain, "plain, sliced")
    _assert_rel(joined, _jax_vjp(args, cots), "plain, sliced, against JAX")


@pytest.mark.parametrize("B,H,units,ok", [
    (4, 512, 4, True), (14, 512, 4, True), (16, 512, 4, False), (6, 1024, 8, True),
    (8, 1024, 8, False), (1, 556, 5, True), (14, 556, 5, False), (12, 556, 5, True),
    (56, 128, 1, True), (58, 128, 1, False), (64, 64, 1, True), (4, 1028, 8, False),
    (4, 30, 1, False), (4, 996, 12, False), (1, 32, 1, True),
])
def test_lstm_backward_shape_range(B, H, units, ok):
    """One launch of the backward takes the forward's H and units, and as
    many batch rows as 16 batch pairs a warp and two buffers of dg (rows of
    4H) in a block's shared memory allow: 14 at H=512, 6 at H=1024."""
    if ok:
        fused_lstm.check_backward_shape(B, H, units)
    else:
        with pytest.raises(ValueError, match="lstm_seq backward"):
            fused_lstm.check_backward_shape(B, H, units)


@pytest.mark.parametrize("B,H,units,slices", [
    (4, 512, 4, [(0, 4)]), (14, 512, 4, [(0, 14)]), (15, 512, 4, [(0, 8), (8, 15)]),
    (60, 512, 4, [(0, 12), (12, 24), (24, 36), (36, 48), (48, 60)]),
    (28, 1024, 8, [(0, 6), (6, 12), (12, 18), (18, 24), (24, 28)]),
])
def test_lstm_backward_batch_slices(B, H, units, slices):
    assert fused_lstm.backward_batch_slices(B, H, units) == slices
    for b0, b1 in slices:
        fused_lstm.check_backward_shape(b1 - b0, H, units)


@pytest.mark.parametrize("H,B,fits", [
    (512, 4, True), (512, 14, True), (512, 15, False), (1024, 6, True), (1024, 7, False),
])
def test_lstm_backward_smem_bound(H, B, fits):
    """Two buffers of dg, rows of 4H with B rounded up to 2 rows, in float32,
    as backward_smem_bytes in csrc/lstm_seq.cu computes it."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    body = re.search(r"size_t backward_smem_bytes\(int B, int H\) \{(.*?)\n\}", src, re.S)
    assert "return 2 * b_pad * 4 * H * sizeof(float);" in body.group(1)
    b_pad = -(-B // 2) * 2
    assert fused_lstm.backward_smem_bytes(H, B) == 2 * b_pad * 4 * H * 4
    assert (fused_lstm.backward_smem_bytes(H, B) <= fused_lstm.SMEM_LIMIT) == fits


def test_lstm_backward_entry_set_up_once(monkeypatch):
    loads = []

    class Lib:
        lstm_seq_backward_f32 = type("Fn", (), {})()

    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    fused_lstm._backward_entry.cache_clear()
    try:
        assert all(fused_lstm._backward_entry() is Lib.lstm_seq_backward_f32 for _ in range(3))
        assert loads == ["lstm_seq"]
        assert len(Lib.lstm_seq_backward_f32.argtypes) == 20
    finally:
        fused_lstm._backward_entry.cache_clear()


def test_cpu_training_launches_no_kernel(rng):
    """On CPU tensors the plain version runs under autograd: no launch."""
    args, _ = _inputs(rng, 4, 3, 8)
    inputs = [torch.from_numpy(a).requires_grad_() for a in args]
    fused_lstm.reset_launches()
    outs, hT, cT = fused_lstm.fused_lstm_sequence(*inputs)
    (outs.sum() + hT.sum() + cT.sum()).backward()
    assert (fused_lstm.launches, fused_lstm.backward_launches) == (0, 0)
    assert all(t.grad is not None for t in inputs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_lstm_weight_gradient_through_transposed_view(rng, monkeypatch, dtype):
    """As the state encoder calls it: w_hh is weight_hh_l0.t() (a view of a
    (4H, H) parameter, float32 or bfloat16) cast with .float().  With both
    launches stood in for by their plain versions, the parameter gets the
    gradient that autograd through lstm_recurrence gives it, in its own
    dtype and shape, and the masks get none when they do not ask for one."""
    calls = []

    def backward(*a, masks_grad=True):
        calls.append(masks_grad)
        return lstm_recurrence_backward(*a, masks_grad=masks_grad)

    monkeypatch.setattr(fused_lstm, "lstm_seq_cuda", lstm_recurrence)
    monkeypatch.setattr(fused_lstm, "lstm_seq_backward_cuda", backward)
    args, cots = _inputs(rng, 5, 3, 16)
    gates_x, masks, h0, c0, w_hh = map(torch.from_numpy, args)
    grads = []
    for fn in (fused_lstm._FusedLSTM.apply, lstm_recurrence):
        weight = torch.nn.Parameter(w_hh.t().contiguous().to(dtype))
        x = gates_x.clone().requires_grad_()
        outs = fn(x, masks, h0, c0, weight.t().float())
        torch.autograd.backward(outs, tuple(map(torch.from_numpy, cots)))
        assert weight.grad.shape == weight.shape and weight.grad.dtype == dtype
        grads.append((weight.grad, x.grad))
    assert calls == [False]
    for g, r in zip(*grads):
        torch.testing.assert_close(g.float(), r.float(), atol=1e-5, rtol=1e-5)
