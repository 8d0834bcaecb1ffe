"""The LSTM's wide kernels (csrc/lstm_seq.cu past H = 1024 or 8 units a
block) in their order of summation, against the JAX package.

The kernels run only on the card (chip_smoke.py holds them against the
plain versions there).  Here plain float32 torch emulates the order in
which each sums, and the emulations are held to the JAX package's scan,
its interpret-mode Pallas kernel and its custom VJP, and to the port's plain
versions, at wide shapes a CPU can take: wide by H (H = 1030, padded to
1032 by the wrapper: 8 units a block on 132 SMs, past the narrow kernels'
1024) and wide by units (H = 96 at 12 units a block, a card of 8 SMs).
Tolerances, float32 on both sides: the forward's outputs within 1e-5
absolute; each of the backward's five gradients (the masks' included)
within 1e-5 of its norm, the reverse sums running over 4H in another order
than XLA's.

* :func:`_wide_forward_emulation`: lstm_seq_wide_kernel.  Warp w takes its
  units in pairs of slots; lane l sums, for each of the pair's 8 gate rows
  and each batch row, its 16-byte chunks c = l + 32j of W_hh's row in
  increasing j, the four values of a chunk in turn, whether the item lies
  in registers, in shared memory or in the ring; a reduce-scatter xor tree
  over the 32 lanes (the additions of a full xor tree, offsets 16 .. 1)
  sums the lanes.
* :func:`_wide_partials_dot`: lstm_seq_backward_partials_wide_kernel.
  Block j (units j·U + u) forms, for every row b and entry k, its partial
  sum of dg[b, gate·H + v]·W_hh[k, gate·H + v] unit by unit, the four gates
  in turn, from 0; in a cluster of C blocks rank r's partials are summed
  rank by rank from 0 (through distributed shared memory) into the
  cluster's set; the G lanes of a cell (G = 32 halved while cells·G > 256)
  sum the sets sub, sub + G, ... in turn, and an xor tree over the G lanes
  (offsets G/2 .. 1) sums those.
* the route of the wide forward by shape (the direct wide kernel where one buffer
  of h does not fit beside the rings), and the shared-memory formulas,
  read from the source.
"""

import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.ops import pallas_lstm as jax_lstm
from robo_vln_tpu_torch.ops import _build, fused_lstm
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
from tests.test_torch_lstm_backward import (_assert_rel, _backward_kernel_emulation, _inputs,
                                            _jax_vjp)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
# (T, B, H, units a block, SMs): wide by H on the H100, wide by units on 8 SMs
WIDE_SHAPES = [(3, 4, 1030, 8, 132), (4, 3, 96, 12, 8)]


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


def _tanh(x):
    return 1.0 - 2.0 / (torch.exp(2.0 * x) + 1.0)


def _wide_forward_emulation(gates_x, masks, h0, c0, w_hh):
    """lstm_seq_wide_kernel's arithmetic in plain float32 torch (H a
    multiple of 4, as the wrapper pads it).  Every gate row of every unit
    is summed the same way, whichever block, warp, pair and slot own it:
    lane l of the warp adds h[b, k]·W_hh[k, row] for its chunks c = l + 32j
    (k = 4c + i) in increasing j and i; chunks past H are no lane's (a lane
    past the last chunk skips it); the reduce-scatter tree over the lanes
    pairs them as a full xor tree (offsets 16, 8, 4, 2, 1).  The mask
    multiplies the product (fmaf(m, g, gx)) and c; the activations are
    written through exp, as the kernel writes them."""
    T, B, four_h = gates_x.shape
    H = four_h // 4
    chunks = H // 4
    kc = -(-chunks // 32)
    k_pad = kc * 128
    w = torch.zeros(k_pad, four_h)
    w[:H] = w_hh
    w = w.view(kc, 32, 4, four_h)  # k = 128·j + 4·lane + i
    lanes = torch.arange(32)
    h, c = h0, c0
    outs = []
    for t in range(T):
        hp = torch.zeros(B, k_pad)
        hp[:, :H] = h
        hp = hp.view(B, kc, 32, 4)
        acc = torch.zeros(B, 32, four_h)
        for j in range(kc):
            live = (lanes + 32 * j < chunks).float()[None, :, None]
            for i in range(4):
                acc = acc + live * (hp[:, j, :, i, None] * w[None, j, :, i])
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        m = masks[t][:, None]
        g = gates_x[t] + m * acc[:, 0]
        gi, gf, gg, go = g.chunk(4, dim=-1)
        c = _sigmoid(gf) * (c * m) + _sigmoid(gi) * _tanh(gg)
        h = _sigmoid(go) * _tanh(c)
        outs.append(h)
    return torch.stack(outs), h, c


def _cell_lanes(cells):
    """G: the lanes of one cell in the wide backward's gather."""
    lanes = 32
    while lanes > 1 and cells * lanes > 256:
        lanes //= 2
    return lanes


def _wide_partials_dot(w_hh, units, cluster):
    """dh~ = dg·W_hh^T as lstm_seq_backward_partials_wide_kernel forms it
    on a grid of ceil(H / units) blocks rounded up to clusters of
    ``cluster`` (see the module's note)."""
    H = w_hh.shape[0]
    blocks = -(-H // units)
    grid = -(-blocks // cluster) * cluster
    sets = grid // cluster
    v = torch.arange(grid)[None] * units + torch.arange(units)[:, None]  # (units, grid)
    valid = (v < H).float()
    v = v.clamp(max=H - 1)
    w = w_hh.reshape(H, 4, H)

    def dot(dg):
        B = dg.shape[0]
        d = dg.view(B, 4, H)
        part = torch.zeros(grid, B, H)
        for u in range(units):
            for gate in range(4):
                dv = d[:, gate, v[u]] * valid[u]  # (B, grid)
                wv = w[:, gate, v[u]] * valid[u]  # (H, grid)
                part = part + dv.t()[:, :, None] * wv.t()[:, None, :]
        part = part.view(sets, cluster, B, H)
        summed = torch.zeros(sets, B, H)
        for rank in range(cluster):
            summed = summed + part[:, rank]
        lanes = _cell_lanes(B * units)
        rounds = -(-sets // lanes)
        padded = torch.zeros(rounds * lanes, B, H)
        padded[:sets] = summed
        padded = padded.view(rounds, lanes, B, H)
        acc = torch.zeros(lanes, B, H)
        for r in range(rounds):
            acc = acc + padded[r]
        off = lanes // 2
        while off:
            acc = acc + acc[torch.arange(lanes) ^ off]
            off //= 2
        return acc[0]
    return dot


@pytest.mark.parametrize("T,B,H,units,n_sm", WIDE_SHAPES)
def test_wide_forward_order_matches_jax(rng, T, B, H, units, n_sm):
    """The wide forward's order, at H padded as the wrapper pads it, against
    the JAX scan and the interpret-mode Pallas kernel (within 1e-5), and
    against the plain version; the shape takes the wide kernel."""
    Hp = fused_lstm.padded_hidden(H)
    assert fused_lstm._units_per_block(H, n_sm) == units
    assert fused_lstm.wide_kernel(Hp, units) and not fused_lstm.wide_forward_direct(B, Hp)
    args, _ = _inputs(rng, T, B, H)
    ours = fused_lstm.padded_forward(_wide_forward_emulation, *map(torch.from_numpy, args))
    scan = jax_lstm._scan_impl(*map(jnp.asarray, args))
    pallas = jax_lstm._pallas_lstm_call(*map(jnp.asarray, args), interpret=True)
    plain = lstm_recurrence(*map(torch.from_numpy, args))
    for o, s, p, q in zip(ours, scan, pallas, plain):
        np.testing.assert_allclose(o.numpy(), np.asarray(s), atol=ATOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), atol=ATOL)
        np.testing.assert_allclose(o.numpy(), q.numpy(), atol=ATOL)


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("T,B,H,units,n_sm", WIDE_SHAPES)
def test_wide_backward_order_matches_jax(rng, T, B, H, units, n_sm, cluster):
    """The wide backward's order (each block's partials, the cluster's sums
    rank by rank, the gather over the sets), inside the wrapper's
    reverse_pass and padded_backward, from the emulated forward's outs,
    against the JAX custom VJP and the plain backward: all five gradients,
    the masks' included, within 1e-5 of each one's norm.  The units are
    the wrapper's (the forward's grid) and the clusters each size the
    kernel may take (H = 1030: 129 blocks, a last cluster of padding
    blocks)."""
    Hp = fused_lstm.padded_hidden(H)
    assert fused_lstm.backward_units_per_block(H, n_sm) == units
    args, cots = _inputs(rng, T, B, H)
    targs = list(map(torch.from_numpy, args))
    tcots = list(map(torch.from_numpy, cots))
    outs = fused_lstm.padded_forward(_wide_forward_emulation, *targs)[0]
    launch = functools.partial(
        _backward_kernel_emulation,
        dot=lambda w: _wide_partials_dot(w, units, cluster))

    def padded(*a, masks_grad=True):
        assert a[2].shape[-1] == Hp
        return fused_lstm.reverse_pass(launch, fused_lstm.backward_batch_slices(B, Hp, units),
                                       *a, masks_grad)

    got = fused_lstm.padded_backward(padded, *targs, outs, *tcots)
    _assert_rel(got, _jax_vjp(args, cots), f"wide T={T} B={B} H={H} cluster {cluster}")
    _assert_rel(got, lstm_recurrence_backward(*targs, outs, *tcots),
                f"wide T={T} B={B} H={H} cluster {cluster}, plain")


def test_wide_gather_lanes():
    """The gather's lanes a cell at the wrapper's shapes: 64 cells (B = 4,
    16 units: H = 2048) take 4 lanes, 128 take 2, 256 one, 48 (H = 96 at 12
    units, 4 rows) 4; the source halves them the same way."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    assert "while (lanes > 1 && cells * lanes > kThreads) lanes >>= 1;" in src
    assert [_cell_lanes(c) for c in (64, 128, 256, 48, 8)] == [4, 2, 1, 4, 32]


@pytest.mark.parametrize("B,H,direct", [
    (4, 1032, False), (4, 2048, False), (8, 4096, False), (8, 6168, False), (8, 6172, True),
    (8, 6400, True), (4, 12404, False), (4, 12408, True), (1, 49616, False), (1, 49620, True),
])
def test_wide_forward_route_by_shape(B, H, direct):
    """The wide forward takes the direct wide kernel (lanes reading h from the
    exchange) only where one buffer of h (B, H), the warps' sums and the
    rings do not fit a block's shared memory: B·H above about 49,000, so
    every shape that phase 14 and phase 3c run at H = 1030, 2048 and 4096
    takes the new kernel, and H = 6400 at 8 rows the direct one."""
    assert fused_lstm.wide_forward_direct(B, H) == direct


def _c_function(src, name):
    m = re.search(r"size_t " + name + r"\((.*?)\n\}\n", src, re.S)
    assert m, name
    return m.group(1)


def test_wide_smem_formulas_match_the_source():
    """The wrappers' shared-memory predicates read the source's constants
    and formulas: 8 warps' rings of kWideRing = 2 items of 2 KiB and their
    mbarriers (and one a warp for its items' first copies); the forward's one buffer of h (B, H) and 8 x 8R sums (R = 4,
    or kWideRows = 8 past 4 rows), 0 (the direct wide kernel) where those and the
    rings do not fit; the backward's two buffers of its cells' dg (2 x U x
    4 x R) and, in a cluster, its partials (B, H)."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    assert f"constexpr int kWideRing = {fused_lstm.WIDE_RING};" in src
    assert f"constexpr int kWideRows = {fused_lstm.WIDE_ROWS};" in src
    assert "constexpr int kItemBytes = 4 * 32 * (int)sizeof(float4);" in src
    assert fused_lstm.ITEM_BYTES == 4 * 32 * 16
    assert "constexpr int wide_rows(int B) { return B <= 4 ? 4 : kWideRows; }" in src
    assert [fused_lstm.wide_rows(b) for b in (1, 4, 5, 8)] == [4, 4, 8, 8]
    assert "kWideRingBytes = (size_t)kWarps * kWideRing * kItemBytes;" in src
    assert "kWideBarBytes = (size_t)kWarps * (kWideRing + 1) * sizeof(u64);" in src
    forward = _c_function(src, "wide_forward_smem")
    assert ("const size_t fixed = (size_t)B * H * sizeof(float) + (size_t)kWarps * 8 * R * "
            "sizeof(float) +\n                       kWideBarBytes;") in forward
    assert "if (fixed + kWideRingBytes > (size_t)kMaxSmem) return 0;" in forward
    backward = _c_function(src, "wide_backward_smem")
    assert ("const size_t fixed = (C > 1 ? (size_t)B * H * sizeof(float) : 0) +\n"
            "                       2 * (size_t)U * 4 * R * sizeof(float) + kWideBarBytes;"
            ) in backward
    assert "if (fixed + kWideRingBytes > (size_t)kMaxSmem) return 0;" in backward
    ring = 8 * (2 * 2048 + 3 * 8)
    for B in (1, 4, 5, 8):
        for H in (1032, 2048, 4096, 6168, 6172, 49616, 49620):
            R = 4 if B <= 4 else 8
            assert fused_lstm.wide_forward_direct(B, H) == (
                4 * B * H + 4 * 8 * 8 * R + ring > fused_lstm.SMEM_LIMIT)
    for units in (8, 16, 32, 64, 779, 780, 1558, 1559):
        want = next((b for b in (8, 4) if 4 * 2 * units * 4 * (4 if b <= 4 else 8) + ring
                     <= fused_lstm.SMEM_LIMIT), 0)
        assert fused_lstm.max_backward_batch(2048, units) == want


def test_wide_backward_picks_clusters_before_the_launch():
    """The wide backward takes clusters of 4, else 2, where the card keeps
    every cluster of the grid co-resident (cudaOccupancyMaxActiveClusters,
    read once a device), else none; the launch is cooperative with the
    cluster attribute (cudaLaunchKernelEx).  The choice is made from the
    shape and the device before any launch, and a failed launch raises."""
    src = (_build.CSRC / "lstm_seq.cu").read_text()
    assert "constexpr int kWideClusters[] = {4, 2};" in src
    assert "cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)" in src
    assert "attr[0].id = cudaLaunchAttributeCooperative;" in src
    assert "const cudaError_t err = cudaLaunchKernelExC(&cfg, kernel, args);" in src
    assert 'extern "C" int lstm_seq_backward_partials_wide_cluster(int B, int H, int U, int dev)' \
        in src
