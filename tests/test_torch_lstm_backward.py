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
* an emulation of each of csrc/lstm_seq.cu's backward kernels in plain
  float32 torch (the c_t sweep, the exchange, and dh~'s sums in the
  kernel's order: for ``partials`` each block's partial over its columns
  of W_hh, then the partials of every block summed by the lanes of a unit
  and an xor tree; for ``dg_exchange`` each lane's chunks of the 4H dot
  product and the xor tree over the lanes), run inside the wrapper's own
  :func:`ops.fused_lstm.reverse_pass`;
* batch slices, joined, against the whole batch;
* the backward's shape predicate and shared-memory formula, its C entry's
  set-up, and ``_FusedLSTM`` with stand-ins for both launches, its weight a
  transposed bfloat16 view.  The kernel itself runs only on the card:
  chip_smoke.py holds it against the plain version there.
"""

import functools
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
from tests.test_torch_threads import one_torch_thread  # noqa: F401

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


def _dg_exchange_dot(w_hh):
    """dh~ = dg·W_hh^T as lstm_seq_backward_kernel forms it for unit v: lane
    l sums, chunk j by chunk j (k = 128·j + 4·l + i) and within a chunk gate
    by gate, the four values of its 16-byte chunk of each gate segment of dg
    times W_hh[v, :]; an xor-shuffle tree (offsets 16, 8, 4, 2, 1) sums the
    lanes."""
    H = w_hh.shape[0]
    k_pad = -(-H // 128) * 128  # chunks past H are a lane's zeros
    kc = k_pad // 128
    w = torch.zeros(H, 4, k_pad)
    w[:, :, :H] = w_hh.reshape(H, 4, H)
    w = w.view(H, 4, kc, 32, 4)
    lanes = torch.arange(32)

    def dot(dg):
        B = dg.shape[0]
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
    return dot


def _partials_dot(w_hh, units):
    """dh~ = dg·W_hh^T as lstm_seq_backward_partials_kernel forms it.  Block
    j (units v = j·units + u, u < units, v < H) sums, for every row b and
    unit k, dg[b, gate·H + v]·W_hh[k, gate·H + v] gate by gate and unit by
    unit, from 0; for cell (b, v) the ``lanes`` lanes of unit u sum the
    partials of blocks sub, sub + lanes, ... in turn (lane sub), and an xor
    tree over the lanes (offsets 16, 8, ..., 32 / lanes) sums those."""
    H = w_hh.shape[0]
    blocks = -(-H // units)
    lanes = fused_lstm.partials_lanes(units)
    up = 32 // lanes
    v = torch.arange(blocks)[None] * units + torch.arange(units)[:, None]  # (units, blocks)
    valid = (v < H).float()
    v = v.clamp(max=H - 1)
    w = w_hh.reshape(H, 4, H)

    def dot(dg):
        B = dg.shape[0]
        d = dg.view(B, 4, H)
        part = torch.zeros(blocks, B, H)
        for gate in range(4):
            for u in range(units):
                dv = d[:, gate, v[u]] * valid[u]      # (B, blocks)
                wv = w[:, gate, v[u]] * valid[u]      # (H, blocks)
                part = part + dv.t()[:, :, None] * wv.t()[:, None, :]
        rounds = -(-blocks // lanes)
        padded = torch.zeros(rounds * lanes, B, H)
        padded[:blocks] = part
        padded = padded.view(rounds, lanes, B, H)
        acc = torch.zeros(lanes, B, H)
        for r in range(rounds):
            acc = acc + padded[r]
        off = 16
        while off >= up:
            acc = acc + acc[torch.arange(lanes) ^ (off // up)]
            off //= 2
        return acc[0]
    return dot


def _backward_kernel_emulation(gates, masks, c0, w_hh, g_outs, g_hT, g_cT, masks_grad,
                               kernel="partials", units=None, dot=None):
    """One of csrc/lstm_seq.cu's backward kernels over one launch's rows, in
    plain float32 torch, with the launch's outputs (d_gates, d_h0, d_c0,
    c_t, dh~, dc~): ``partials`` (lstm_seq_backward_partials_kernel, at
    ``units`` units a block, by default the wrapper's on the H100's 132 SMs) or
    ``dg_exchange`` (lstm_seq_backward_kernel), or ``dot(w_hh)``'s sums for
    another kernel's order.  The owner of each cell
    sweeps c_t forward; then, from t = T-1, the cell update gives dg_t, and
    dh~_t comes from the kernel's sums (:func:`_partials_dot`,
    :func:`_dg_exchange_dot`; the exchanges move float bits).  The
    activations are written through exp, as the kernels write them."""
    T, B, four_h = gates.shape
    H = four_h // 4
    if dot is not None:
        dot = dot(w_hh)
    elif kernel == "partials":
        dot = _partials_dot(w_hh, units or fused_lstm.backward_units_per_block(H, 132))
    else:
        dot = _dg_exchange_dot(w_hh)

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


@pytest.mark.parametrize("kernel,units", [("partials", None), ("partials", 5),
                                          ("dg_exchange", None)])
@pytest.mark.parametrize("T,B,H", SHAPES[:4])
def test_lstm_backward_kernel_summation_order_matches_jax(rng, T, B, H, kernel, units):
    """Each kernel's order of operations, inside the wrapper's reverse_pass
    and from the forward kernel's emulated outs, against the JAX VJP (H =
    556: a partial last chunk of lanes and a ragged grid); ``partials`` at
    the wrapper's units (8 at H = 512 and 556) and at 5, the lanes of a unit
    padded to 8's."""
    args, cots = _inputs(rng, T, B, H)
    targs = list(map(torch.from_numpy, args))
    outs = _lstm_kernel_emulation(*targs)[0]
    launch = functools.partial(_backward_kernel_emulation, kernel=kernel, units=units)
    got = fused_lstm.reverse_pass(launch, [(0, B)], *targs, outs,
                                  *map(torch.from_numpy, cots), True)
    _assert_rel(got, _jax_vjp(args, cots), f"{kernel} T={T} B={B} H={H}")


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


@pytest.mark.parametrize("kernel,B,H,units,ok", [
    ("dg_exchange", *case) for case in (
        (4, 512, 4, True), (14, 512, 4, True), (16, 512, 4, False), (6, 1024, 8, True),
        (8, 1024, 8, False), (1, 556, 5, True), (14, 556, 5, False), (12, 556, 5, True),
        (56, 128, 1, True), (58, 128, 1, False), (64, 64, 1, True), (4, 1028, 8, False),
        (4, 30, 1, False), (4, 996, 12, False), (1, 32, 1, True))
] + [
    ("partials", *case) for case in (
        (4, 512, 8, True), (32, 512, 8, True), (33, 512, 8, False), (64, 512, 4, True),
        (65, 512, 4, False), (32, 1024, 8, True), (33, 1024, 8, False), (32, 556, 5, True),
        (33, 556, 5, False), (256, 128, 1, True), (257, 128, 1, False), (128, 256, 2, True),
        (129, 256, 2, False), (4, 1028, 8, True), (4, 30, 1, True), (4, 996, 12, True),
        (4, 96, 9, True), (1, 32, 1, True), (8, 2048, 32, True), (9, 2048, 32, False),
        (8, 2048, 16, True), (9, 2048, 16, False), (8, 4096, 32, True), (8, 1030, 8, True),
        (8, 8448, 64, True))
])
def test_lstm_backward_shape_range(kernel, B, H, units, ok):
    """One launch of the backward takes as many batch rows as its kernel
    holds: ``dg_exchange`` (forced only) keeps its range, H a multiple of 4
    up to 1024 and 8 units a block, as 16 batch pairs a warp and two buffers
    of dg (rows of 4H) in a block's shared memory allow (14 at H=512, 6 at
    H=1024); ``partials``, the route, takes any H (padded to a multiple of
    4) and units, one owner lane a cell, 32 / U_p rows in each of 8 warps
    (U_p: the units rounded up to a power of 2; 32 rows at 5 to 8 units, 64
    at 3 or 4), and 8 rows in its wide variant (past H = 1024 or 8 units)."""
    if ok:
        fused_lstm.check_backward_shape(B, H, units, kernel)
    else:
        with pytest.raises(ValueError, match="lstm_seq backward"):
            fused_lstm.check_backward_shape(B, H, units, kernel)


@pytest.mark.parametrize("kernel,B,H,units,slices", [
    ("dg_exchange", 4, 512, 4, [(0, 4)]), ("dg_exchange", 14, 512, 4, [(0, 14)]),
    ("dg_exchange", 15, 512, 4, [(0, 8), (8, 15)]),
    ("dg_exchange", 60, 512, 4, [(0, 12), (12, 24), (24, 36), (36, 48), (48, 60)]),
    ("dg_exchange", 28, 1024, 8, [(0, 6), (6, 12), (12, 18), (18, 24), (24, 28)]),
    ("partials", 4, 512, 8, [(0, 4)]), ("partials", 32, 512, 8, [(0, 32)]),
    ("partials", 60, 512, 8, [(0, 30), (30, 60)]),
    ("partials", 100, 1024, 8, [(0, 25), (25, 50), (50, 75), (75, 100)]),
])
def test_lstm_backward_batch_slices(kernel, B, H, units, slices):
    assert fused_lstm.backward_batch_slices(B, H, units, kernel) == slices
    for b0, b1 in slices:
        fused_lstm.check_backward_shape(b1 - b0, H, units, kernel)


@pytest.mark.parametrize("H,units", [(512, 8), (1024, 8), (556, 8), (256, 4), (128, 2),
                                     (64, 1), (32, 1), (1000, 8), (1030, 8), (2048, 16),
                                     (4096, 32)])
def test_lstm_backward_units(H, units):
    """``partials`` takes enough units a block for a grid of about
    BACKWARD_BLOCKS (64) blocks on the H100's 132 SMs, at least the
    forward's and at most MAX_UNITS; at the wide shapes (H = 1030, padded to
    1032, 2048 and 4096) the forward's grid, the whole card; ``dg_exchange``
    takes the forward's."""
    assert fused_lstm.backward_units_per_block(H, 132, "partials") == units
    assert (fused_lstm.backward_units_per_block(H, 132, "dg_exchange")
            == fused_lstm._units_per_block(H, 132))
    assert -(-H // units) <= 132


@pytest.mark.parametrize("kernel,H,B,fits", [
    ("dg_exchange", 512, 4, True), ("dg_exchange", 512, 14, True),
    ("dg_exchange", 512, 15, False), ("dg_exchange", 1024, 6, True),
    ("dg_exchange", 1024, 7, False),
    ("partials", 512, 4, True), ("partials", 1024, 32, True), ("partials", 128, 256, True),
])
def test_lstm_backward_smem_bound(kernel, H, B, fits):
    """``dg_exchange``: two buffers of dg, rows of 4H with B rounded up to 2
    rows, in float32, as backward_smem_bytes in csrc/lstm_seq.cu computes
    it.  ``partials``: two buffers of the block's cells' dg, (B, 4 gates,
    kMaxUnits) floats (partials_smem_bytes), whatever H: 64 KiB at its most
    rows (256, at one unit a block)."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    if kernel == "dg_exchange":
        body = re.search(r"size_t backward_smem_bytes\(int B, int H\) \{(.*?)\n\}", src, re.S)
        assert "return 2 * b_pad * 4 * H * sizeof(float);" in body.group(1)
        b_pad = -(-B // 2) * 2
        assert fused_lstm.backward_smem_bytes(H, B, kernel) == 2 * b_pad * 4 * H * 4
    else:
        assert ("size_t partials_smem_bytes(int B) { return 2 * (size_t)B * 4 * kMaxUnits * "
                "sizeof(float); }") in src
        assert f"constexpr int kMaxUnits = {fused_lstm.MAX_UNITS};" in src
        assert fused_lstm.backward_smem_bytes(H, B, kernel) == 2 * B * 4 * fused_lstm.MAX_UNITS * 4
    assert (fused_lstm.backward_smem_bytes(H, B, kernel) <= fused_lstm.SMEM_LIMIT) == fits


def test_lstm_backward_partials_rows_match_the_c_entry():
    """The C entry of the partials kernel refuses what the wrapper refuses:
    more than kMaxUnits units, or more rows than 32 / U_p a warp."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    assert "return kWarps * (32 / up);" in src
    assert ("if (U < 1 || U > kMaxUnits || B < 1 || B > partials_max_rows(U))\n"
            "    return (int)cudaErrorInvalidValue;") in src
    for units, rows in ((1, 256), (2, 128), (3, 64), (4, 64), (5, 32), (8, 32)):
        assert fused_lstm.max_backward_batch(512, units, "partials") == rows


@pytest.mark.parametrize("kernel,entry,exchange", [
    ("dg_exchange", "lstm_seq_backward_f32", "lstm_seq_backward_exchange"),
    ("partials", "lstm_seq_backward_partials_f32", "lstm_seq_backward_partials_exchange"),
])
def test_lstm_backward_entry_set_up_once(monkeypatch, kernel, entry, exchange):
    """Each backward kernel's C entry (20 arguments) and its exchange-only
    entry (7), loaded and set up once."""
    loads = []

    class Lib:
        pass

    for name in (entry, exchange):
        setattr(Lib, name, type("Fn", (), {})())
    monkeypatch.setattr(_build, "load", lambda name: loads.append(name) or Lib)
    fused_lstm._backward_entry.cache_clear()
    fused_lstm._exchange_entry.cache_clear()
    try:
        assert all(fused_lstm._backward_entry(kernel) is getattr(Lib, entry) for _ in range(3))
        assert fused_lstm._exchange_entry(exchange) is getattr(Lib, exchange)
        assert loads == ["lstm_seq", "lstm_seq"]
        assert len(getattr(Lib, entry).argtypes) == 20
        assert len(getattr(Lib, exchange).argtypes) == 7
        src = (_build.CSRC / "lstm_seq.cu").read_text()
        assert f'extern "C" int {entry}(' in src and f'extern "C" int {exchange}(' in src
    finally:
        fused_lstm._backward_entry.cache_clear()
        fused_lstm._exchange_entry.cache_clear()


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


@pytest.mark.parametrize("H", [30, 1030])
def test_lstm_padded_form_matches_jax(rng, H):
    """H off a multiple of 4 runs padded to the next one: the wrapper's
    padded forms (fused_lstm.padded_forward and padded_backward, which the
    kernels' wrappers call) around the plain versions give the JAX scan's
    outputs and final state within 1e-5, and the JAX VJP's five gradients
    within 1e-5 of each one's norm; the padded units' h, c and gradients are
    exactly 0 (H = 1030 pads to 1032, past the kernel's 1024: the wide
    variant's shape)."""
    T, B = 3, 2
    args, cots = _inputs(rng, T, B, H)
    Hp = fused_lstm.padded_hidden(H)
    assert Hp % 4 == 0 and 0 < Hp - H < 4
    targs = [torch.from_numpy(a) for a in args]
    seen = []

    def plain(*padded):
        seen.append(padded[2].shape[-1])
        res = lstm_recurrence(*padded)
        for t in res:
            assert torch.all(t[..., H:] == 0)
        return res

    got = fused_lstm.padded_forward(plain, *targs)
    assert seen == [Hp]
    for g, r in zip(got, jax_lstm._scan_impl(*map(jnp.asarray, args))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)

    def plain_backward(*padded, masks_grad=True):
        seen.append(padded[2].shape[-1])
        grads = lstm_recurrence_backward(*padded, masks_grad=masks_grad)
        d_gates, _, d_h0, d_c0, d_w_hh = grads
        assert torch.all(d_gates.unflatten(-1, (4, Hp))[..., H:] == 0)
        assert torch.all(d_h0[:, H:] == 0) and torch.all(d_c0[:, H:] == 0)
        assert torch.all(d_w_hh[H:] == 0)
        return grads

    grads = fused_lstm.padded_backward(plain_backward, *targs, got[0],
                                       *map(torch.from_numpy, cots))
    assert seen == [Hp, Hp]
    assert [tuple(g.shape) for g in grads] == [a.shape for a in args]
    _assert_rel(grads, _jax_vjp(args, cots), f"padded H={H}")
