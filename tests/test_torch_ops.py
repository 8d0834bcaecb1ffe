"""Port ops against the JAX package: the plain masked LSTM and the plain
cross-modal attention, each held against the JAX XLA path and the
interpret-mode Pallas kernel on the same numpy inputs (f32, atol 1e-5; bf16
inputs to one bf16 ulp of the output), the dispatch of attention_core, and
the arithmetic of the bf16 attention kernel emulated in plain torch.  The
CUDA kernels have no CPU mode: chip_smoke.py holds them against these plain
versions on the card."""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robo_vln_tpu.ops import cm_attention as jax_cm
from robo_vln_tpu.ops import pallas_lstm as jax_lstm
from robo_vln_tpu.ops.pallas_attention import _pallas_attention, _xla_impl
from robo_vln_tpu_torch.ops import _build, cm_attention, fused_attention, fused_lstm
from robo_vln_tpu_torch.ops.rnn import (lstm_recurrence, lstm_recurrence_backward,
                                        lstm_sequence)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _lstm_inputs(rng, T, B, H):
    masks = np.ones((T, B), np.float32)
    masks[0] = 0.0
    if T > 2:
        masks[T // 2, B - 1] = 0.0  # a reset in the middle of the window
    return (
        rng.standard_normal((T, B, 4 * H)).astype(np.float32),
        masks,
        rng.standard_normal((B, H)).astype(np.float32),
        rng.standard_normal((B, H)).astype(np.float32),
        (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32),
    )


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=atol)


@pytest.mark.parametrize("T,B,H", [(6, 3, 32), (4, 1, 16), (1, 1, 32), (1, 4, 8)])
def test_lstm_recurrence_matches_scan_and_pallas(rng, T, B, H):
    args = _lstm_inputs(rng, T, B, H)
    ours = lstm_recurrence(*map(torch.from_numpy, args))
    scan = jax_lstm._scan_impl(*map(jnp.asarray, args))
    pallas = jax_lstm._pallas_lstm_call(*map(jnp.asarray, args), interpret=True)
    for o, s, p in zip(ours, scan, pallas):
        _close(o, s)
        _close(o, p)


def test_lstm_sequence_fused_matches_jax(rng):
    """The fused wrapper's API, input projection included; on CPU tensors it
    runs the plain version and launches nothing."""
    T, B, D, H = 5, 2, 12, 16
    gates_x, masks, h0, c0, w_hh = _lstm_inputs(rng, T, B, H)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    w_ih = (rng.standard_normal((D, 4 * H)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4 * H).astype(np.float32)
    np_args = (x, h0, c0, masks, w_ih, w_hh, b)
    fused_lstm.reset_launches()
    outs, (hT, cT) = fused_lstm.lstm_sequence_fused(*map(torch.from_numpy, np_args))
    assert fused_lstm.launches == 0
    ref_outs, (ref_h, ref_c) = jax_lstm.lstm_sequence_fused(*map(jnp.asarray, np_args))
    for o, r in ((outs, ref_outs), (hT, ref_h), (cT, ref_c)):
        _close(o, r)
    plain_outs, _ = lstm_sequence(*map(torch.from_numpy, np_args))
    _close(outs, plain_outs, atol=0.0)


@pytest.mark.parametrize("H,n_sm,units", [(512, 132, 4), (512, 100, 6), (32, 132, 1), (48, 16, 3),
                                          (556, 132, 5)])
def test_lstm_units_per_block(H, n_sm, units):
    """The fewest units a block that keep ceil(H / units) blocks within the
    SMs; the last block may own fewer (H = 556: 111 blocks of 5, one of 1)."""
    assert fused_lstm._units_per_block(H, n_sm) == units


def _qkv(rng, N, Lq, S, D, Dv):
    return (rng.standard_normal((N, Lq, D)).astype(np.float32),
            rng.standard_normal((N, S, D)).astype(np.float32),
            rng.standard_normal((N, S, Dv)).astype(np.float32))


ATTN_SHAPES = [  # N, Lq, S, D, Dv, heads
    (2, 16, 16, 256, 256, 4),  # rgb tokens, HCM head layout (d_k = 64)
    (2, 16, 64, 256, 256, 4),  # depth tokens
    (3, 8, 8, 16, 16, 2),  # tiny
    (2, 8, 64, 256, 128, 2),  # rectangular d_v
]


@pytest.mark.parametrize("N,Lq,S,D,Dv,heads", ATTN_SHAPES)
def test_attention_plain_matches_xla_and_pallas(rng, N, Lq, S, D, Dv, heads):
    q, k, v = _qkv(rng, N, Lq, S, D, Dv)
    ours = fused_attention.attention_plain(*map(torch.from_numpy, (q, k, v)), heads)
    _close(ours, jax_cm.mha_attention(*map(jnp.asarray, (q, k, v)), heads))
    _close(ours, _pallas_attention(*map(jnp.asarray, (q, k, v)), heads, interpret=True))
    fused_attention.reset_launches()
    core = cm_attention.attention_core(*map(torch.from_numpy, (q, k, v)), heads)
    assert fused_attention.launches == 0  # CPU tensors take the plain version
    _close(core, ours, atol=0.0)


def _bf16_ulp(x):
    """One bfloat16 ulp (8 significant bits) at the magnitude of x."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _largest_term(q, k, v, heads):
    """max_k p_k·|v_k| of each output, p the float32 softmax of the bf16
    inputs: the largest term of the output's sum."""
    N, Lq, D = q.shape
    S, dk, dv = k.shape[1], D // heads, v.shape[-1] // heads
    qh, kh, vh = (torch.as_tensor(np.asarray(t, np.float32)).view(N, -1, heads, d).transpose(1, 2)
                  for t, d in ((q, dk), (k, dk), (v, dv)))
    p = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dk), dim=-1)
    top = (p[..., None] * vh.abs()[:, :, None]).amax(dim=-2)
    return top.transpose(1, 2).reshape(N, Lq, heads * dv).numpy()


def _round_p_tolerance(got, ref, q, k, v, heads):
    """One bf16 ulp of the output, plus one bf16 ulp (at most 2^-7) of the
    output's largest term p_k·|v_k|: where two float32 softmaxes differ in
    their last bits, a p near the midpoint of two bf16 values rounds to
    either, and an output that cancels to far below its terms sees that
    flip as many of its own ulps."""
    return (_bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
            + 2.0 ** -7 * _largest_term(q, k, v, heads))


@pytest.mark.parametrize("float32_p", [True, False])
@pytest.mark.parametrize("N,Lq,S,D,Dv,heads", ATTN_SHAPES)
def test_attention_plain_bf16_matches_pallas(rng, N, Lq, S, D, Dv, heads, float32_p):
    """The contract the bf16 kernel is held to on the card, in each mode of
    p (TPU.PALLAS_ATTENTION).  On (``split_p``): bf16 inputs, the function in
    float32, one rounding of the output to bf16; the plain version and the
    interpret-mode Pallas kernel agree to one bf16 ulp of the output (they
    round float32 results that differ in summation order).  Off
    (``round_p``, the default): p rounded to bf16 before p·v; the plain
    version and JAX's XLA attention (mha_attention in bf16) agree to one
    bf16 ulp of the output plus one of p's roundings that the two float32
    softmaxes may flip (:func:`_round_p_tolerance`)."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(rng, N, Lq, S, D, Dv))
    ours = fused_attention.attention_plain(
        *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in (q, k, v)),
        heads, float32_p=float32_p)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    if float32_p:
        ref = _pallas_attention(*map(jnp.asarray, (q, k, v)), heads, interpret=True)
        tol = _bf16_ulp(np.maximum(np.abs(ours), np.abs(np.asarray(ref, np.float32))))
    else:
        ref = jax_cm.mha_attention(*map(jnp.asarray, (q, k, v)), heads)
        tol = _round_p_tolerance(ours, np.asarray(ref, np.float32), q, k, v, heads)
    ref = np.asarray(ref.astype(jnp.float32))
    assert np.all(np.abs(ours - ref) <= tol)


def _p_split_attention(q, k, v, heads, keep_lo=True):
    """The bf16 kernel's arithmetic in plain torch: q·kᵀ of bf16 values in
    float32, the softmax in float32, p = p_hi + p_lo with p_hi = bf16(p) and
    p_lo = bf16(p - p_hi), then p_hi·v + p_lo·v, each product of bf16 values
    summed in float32 (the ``split_p`` mode).  With ``keep_lo`` False, the
    ``round_p`` mode (the default): the normalised p rounded to bf16 once,
    p_hi·v alone.  Returns the float32 result before the output's
    rounding."""
    N, Lq, D = q.shape
    S, dk, dv = k.shape[1], D // heads, v.shape[-1] // heads
    qh = q.float().view(N, Lq, heads, dk).transpose(1, 2)
    kh = k.float().view(N, S, heads, dk).transpose(1, 2)
    vh = v.float().view(N, S, heads, dv).transpose(1, 2)
    p = torch.softmax(qh @ kh.transpose(-1, -2) * (1.0 / math.sqrt(dk)), dim=-1)
    p_hi = p.to(torch.bfloat16).float()
    p_lo = (p - p_hi).to(torch.bfloat16).float()
    out = p_hi @ vh + (p_lo @ vh if keep_lo else 0.0)
    return out.transpose(1, 2).reshape(N, Lq, heads * dv)


@pytest.mark.parametrize("S", [16, 64])
def test_attention_p_split_keeps_float32_probabilities(rng, S):
    """At the HCM shapes (d = 64, S = 16 rgb or 64 depth tokens) the kernel's
    p_hi + p_lo arithmetic stays within 1e-5 of the float32 function of the
    same bf16 inputs, so the bf16 output's own rounding is the only one that
    counts; p_hi alone would not be (it keeps 8 bits of p)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 2, 32, S, 256, 256))
    ref = fused_attention.attention_plain(q.float(), k.float(), v.float(), 4)
    err = (_p_split_attention(q, k, v, 4) - ref).abs().max().item()
    assert err <= 1e-5
    assert (_p_split_attention(q, k, v, 4, keep_lo=False) - ref).abs().max().item() > 1e-4


def _p_split_attention_blocks(q, k, v, heads, block=16 * fused_attention.BF16_KEY_CHUNKS,
                              slack=8.0, keep_lo=True):
    """The bf16 key-block kernel's arithmetic (S > 128) in plain torch: the
    keys in key blocks of ``block`` (the ring's 32), the last one partial;
    per key block, its logits of bf16 values in float32 and their row max,
    scaled by log2 e / √d_k; a row's reference max m moves to the block's
    max only where that passes m by more than ``slack`` (always at the first
    key block), and the row sum and the output are then rescaled by
    exp2(m_old - m_new); p = exp2(logit·scale - m), at most 2^slack, split
    into p_hi + p_lo, p_lo·v then p_hi·v added to the output and p to the
    row sum; the output divided by the sum at the end.  With ``keep_lo``
    False, the ``round_p`` mode: the unnormalised p rounded to bf16 once,
    p_hi·v alone, the float32 p still into the row sum."""
    N, Lq, D = q.shape
    S, dk, dv = k.shape[1], D // heads, v.shape[-1] // heads
    qh = q.float().view(N, Lq, heads, dk).transpose(1, 2)
    kh = k.float().view(N, S, heads, dk).transpose(1, 2)
    vh = v.float().view(N, S, heads, dv).transpose(1, 2)
    scale2 = np.float32(1.4426950408889634 / math.sqrt(dk))
    m = torch.full((N, heads, Lq, 1), -math.inf)
    total = torch.zeros(N, heads, Lq, 1)
    out = torch.zeros(N, heads, Lq, dv)
    for s0 in range(0, S, block):
        logits = qh @ kh[:, :, s0:s0 + block].transpose(-1, -2)
        block_max = logits.amax(dim=-1, keepdim=True) * scale2
        m_new = torch.where(block_max > m + slack, block_max, m)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(logits * scale2 - m_new)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        vb = vh[:, :, s0:s0 + block]
        out = out * alpha + ((p_lo @ vb if keep_lo else 0.0) + p_hi @ vb)
        total = total * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return (out / total).transpose(1, 2).reshape(N, Lq, heads * dv)


@pytest.mark.parametrize("S,d", [
    pytest.param(129, 64, id="129"), pytest.param(144, 64, id="144"),
    pytest.param(300, 64, id="300"),
    pytest.param(512, 128, id="512-d128"),  # past the parent kernel's shared memory
    pytest.param(1000, 64, id="1000"),
])
def test_attention_key_blocks_keep_float32(rng, S, d):
    """Past S = 128 (the 144 depth tokens of a 384 px frame, and S the
    kernel that held a head's keys whole could not fit, such as 512 at d =
    128), the bf16 kernel's key blocks with an online softmax stay within
    1e-5 of the float32 function of the same bf16 inputs (the plain version
    and JAX's XLA attention), as the one-block arithmetic does at S <= 128."""
    assert 16 * fused_attention.BF16_KEY_CHUNKS == 32 and S > fused_attention.BF16_WHOLE_S
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 2, 24, S, 2 * d, 2 * d))
    ref = fused_attention.attention_plain(q.float(), k.float(), v.float(), 2)
    ours = _p_split_attention_blocks(q, k, v, 2)
    assert (ours - ref).abs().max().item() <= 1e-5
    _close(ours, jax_cm.mha_attention(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), 2))


@pytest.mark.parametrize("S,jump_at", [(144, 64), (300, 200)])
def test_attention_key_blocks_rescale_when_the_max_jumps(rng, S, jump_at):
    """Keys past ``jump_at`` scaled up so that their logits pass the running
    max by far more than the slack of 2^8: the key blocks there move the
    reference max and rescale the sum and the output.  The result holds the
    bound of the split: p - p_hi - p_lo is at most 2^-18 p, so the output
    is off the float32 function of the same bf16 inputs by at most 2^-18
    max|v|, plus float32 rounding (here, of peaked rows, the lazy reference
    leaves even the largest p inexact, where an eager max makes it 1)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 2, 24, S, 128, 128))
    k[:, jump_at:] *= 8
    ref = fused_attention.attention_plain(q.float(), k.float(), v.float(), 2)
    qh = q.float().view(2, 24, 2, 64).transpose(1, 2)
    kh = k.float().view(2, S, 2, 64).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) * (1.4426950408889634 / 8)
    assert (logits[..., jump_at:].amax(-1) - logits[..., :jump_at].amax(-1) > 8).float().mean() > 0.9
    ours = _p_split_attention_blocks(q, k, v, 2)
    bound = 2.0 ** -18 * v.float().abs().max().item() + 1e-6
    assert (ours - ref).abs().max().item() <= bound


def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds it: 10 mantissa bits, to
    nearest at mantissa bit 13, ties away from zero (the sign-magnitude bits
    round up in magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b, hi_only=False):
    """a @ b as the tf32 mma computes it in 3xTF32: each float32 operand
    split into hi = tf32(x) and lo = tf32(x - hi), then a_lo·b_hi + a_hi·b_lo
    first and a_hi·b_hi last, every product of tf32 values exact in float32.
    ``hi_only``: one tf32 product."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    if hi_only:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _3xtf32_attention(q, k, v, heads, hi_only=False, dk=None):
    """The float32 tensor-core kernel's arithmetic in plain torch: q·kᵀ in
    3xTF32, the softmax in base 2 on logits scaled by log2 e / √d_k, p
    normalised, then p·v in 3xTF32.  ``dk``: the head size of the scale,
    where q and k are zero-filled past it (by default their own)."""
    N, Lq, D = q.shape
    S, dv = k.shape[1], v.shape[-1] // heads
    dk, dq = dk or D // heads, D // heads
    qh = q.view(N, Lq, heads, dq).transpose(1, 2)
    kh = k.view(N, S, heads, dq).transpose(1, 2)
    vh = v.view(N, S, heads, dv).transpose(1, 2)
    logits = _mm_3xtf32(qh, kh.transpose(-1, -2), hi_only)
    logits = logits * np.float32(1.4426950408889634 / math.sqrt(dk))
    e = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    out = _mm_3xtf32(p, vh, hi_only)
    return out.transpose(1, 2).reshape(N, Lq, heads * dv)


@pytest.mark.parametrize("dk,dv", [(8, 16), (32, 32), (64, 64)])
@pytest.mark.parametrize("S", [1, 5, 16, 33, 64, 128])
def test_attention_3xtf32_keeps_float32(rng, S, dk, dv):
    """The float32 tensor-core kernel's 3xTF32 arithmetic stays within 1e-5
    of the float32 function (the plain version and the interpret-mode Pallas
    kernel on the same numpy inputs), at S off a multiple of 8 or 16 and at
    d_k != d_v."""
    heads = 2
    q, k, v = _qkv(rng, 2, 24, S, heads * dk, heads * dv)
    ours = _3xtf32_attention(*map(torch.from_numpy, (q, k, v)), heads)
    plain = fused_attention.attention_plain(*map(torch.from_numpy, (q, k, v)), heads)
    _close(ours, plain)
    _close(ours, _pallas_attention(*map(jnp.asarray, (q, k, v)), heads, interpret=True))


def test_attention_1xtf32_is_not_float32(rng):
    """One tf32 product (hi only) at the HCM's d = 64, S = 64 is off the
    float32 function by more than the float32 route's 1e-4: the split is
    what keeps the route float32."""
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 32, 64, 256, 256))
    ref = fused_attention.attention_plain(q, k, v, 4)
    assert (_3xtf32_attention(q, k, v, 4) - ref).abs().max().item() <= 1e-5
    assert (_3xtf32_attention(q, k, v, 4, hi_only=True) - ref).abs().max().item() > 1e-4


def _3xtf32_attention_blocks(q, k, v, heads, block, dk=None):
    """The streamed float32 tensor-core kernel's arithmetic (S > 128, or D
    = 256) in plain torch: the keys in key blocks of ``block``; each block's
    logits in 3xTF32, scaled by log2 e / √d_k; the running row max m
    rescales the row sum and the output by exp2(m_old - m_new); the block's
    unnormalised p = exp2(s - m) goes into p·v in 3xTF32, added to the
    rescaled output; the output divided by the sum at the end.  ``dk`` as
    in _3xtf32_attention."""
    N, Lq, D = q.shape
    S, dv = k.shape[1], v.shape[-1] // heads
    dk, dq = dk or D // heads, D // heads
    qh = q.view(N, Lq, heads, dq).transpose(1, 2)
    kh = k.view(N, S, heads, dq).transpose(1, 2)
    vh = v.view(N, S, heads, dv).transpose(1, 2)
    scale2 = np.float32(1.4426950408889634 / math.sqrt(dk))
    m = torch.full((N, heads, Lq, 1), -math.inf)
    total = torch.zeros(N, heads, Lq, 1)
    out = torch.zeros(N, heads, Lq, dv)
    for s0 in range(0, S, block):
        logits = _mm_3xtf32(qh, kh[:, :, s0:s0 + block].transpose(-1, -2)) * scale2
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(logits - m_new)
        out = out * alpha + _mm_3xtf32(p, vh[:, :, s0:s0 + block])
        total = total * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
    return (out / total).transpose(1, 2).reshape(N, Lq, heads * dv)


@pytest.mark.parametrize("dk,dv", [(64, 64), (128, 128), (64, 32)])
@pytest.mark.parametrize("S", [129, 144, 200, 500])
def test_attention_3xtf32_key_blocks_keep_float32(rng, S, dk, dv):
    """Past S = 128 (a 384 px frame's 144 depth tokens, self-attention over
    200 tokens, longer S), the float32 tensor-core route's key blocks of 32
    keys, with 3xTF32 products and the online rescale, stay within 1e-5 of
    the float32 function: the plain
    version, the JAX package's XLA path and its interpret-mode Pallas
    kernel on the same numpy inputs."""
    heads = 2
    q, k, v = _qkv(rng, 2, 24, S, heads * dk, heads * dv)
    block = 8 * fused_attention.F32_KEY_CHUNKS
    assert block == 32 and S > fused_attention.F32_WHOLE_S
    ours = _3xtf32_attention_blocks(*map(torch.from_numpy, (q, k, v)), heads, block)
    _close(ours, fused_attention.attention_plain(*map(torch.from_numpy, (q, k, v)), heads))
    _close(ours, _xla_impl(*map(jnp.asarray, (q, k, v)), heads))
    _close(ours, _pallas_attention(*map(jnp.asarray, (q, k, v)), heads, interpret=True))


def _copy_tiles(flat, offset, N, L, heads, d, D, narrow):
    """The float32 tensor-core kernels' copy of one of q, k, v, an (N, L,
    heads·d) tensor ``offset`` floats into the flat buffer ``flat``, into
    tiles zero-filled to D columns a head: row r, column c of a head read at
    offset + (n·L + r)·heads·d + head·d + c.  ``narrow``: one float a copy,
    zero from column d on; else 16-byte copies of columns 4j..4j+3, each
    taken whole where 4j < d.  Returns (N, L, heads·D)."""
    n, h, r, c = torch.meshgrid(torch.arange(N), torch.arange(heads), torch.arange(L),
                                torch.arange(D), indexing="ij")
    idx = offset + (n * L + r) * heads * d + h * d + c
    ok = ((c if narrow else c - c % 4) < d) & (idx < flat.numel())
    tiles = torch.where(ok, flat[torch.where(ok, idx, 0)], 0.0)
    return tiles.permute(0, 2, 1, 3).reshape(N, L, heads * D)


def _f32_kernel_emulation(bufs, offsets, N, Lq, S, heads, dk, dv, narrow=None):
    """The float32 tensor-core route's kernel in plain torch, on q, k, v read
    from flat buffers at element offsets: the copy width the wrapper picks
    (unless ``narrow`` is given), the head dims zero-filled to the
    instance's D, the whole-key or key-block arithmetic the route takes,
    the scale of d_k, and the columns below d_v of each head's output."""
    D = fused_attention.f32_instance_d(dk, dv)
    if narrow is None:
        narrow = fused_attention.f32_narrow_copies(dk, dv, all(o % 4 == 0 for o in offsets))
    q, k, v = (_copy_tiles(b, o, N, L, heads, d, D, narrow)
               for b, o, L, d in zip(bufs, offsets, (Lq, S, S), (dk, dk, dv)))
    if fused_attention.f32_key_blocks(S, dk, dv):
        out = _3xtf32_attention_blocks(q, k, v, heads, 8 * fused_attention.f32_key_chunks(D),
                                       dk=dk)
    else:
        out = _3xtf32_attention(q, k, v, heads, dk=dk)
    return out.view(N, Lq, heads, D)[..., :dv].reshape(N, Lq, heads * dv)


@pytest.mark.parametrize("S", [5, 16, 129, 500])
@pytest.mark.parametrize("dk,dv", [(d, d) for d in (1, 12, 60, 61, 100, 136, 200, 256)]
                         + [(60, 136)])
def test_attention_3xtf32_zero_filled_head_dims(rng, S, dk, dv):
    """Head sizes off a multiple of 8 and up to 256 on the float32 tensor-core
    route: the kernels' copies into tiles zero-filled to D (32, 64, 128 or
    256), with the whole-key or key-block arithmetic the route picks (8-key
    blocks at D = 256), from aligned buffers and from buffers one float off
    (one float a copy), stay within 1e-5 of the float32 function: the plain
    version, the JAX package's XLA path and its interpret-mode Pallas
    kernel on the same numpy inputs."""
    N, Lq, heads = 2, 24, 2
    q, k, v = _qkv(rng, N, Lq, S, heads * dk, heads * dv)
    refs = [fused_attention.attention_plain(*map(torch.from_numpy, (q, k, v)), heads),
            _xla_impl(*map(jnp.asarray, (q, k, v)), heads),
            _pallas_attention(*map(jnp.asarray, (q, k, v)), heads, interpret=True)]
    for offset in (0, 1):
        bufs = [torch.cat([torch.zeros(offset), torch.from_numpy(a).flatten()])
                for a in (q, k, v)]
        ours = _f32_kernel_emulation(bufs, (offset,) * 3, N, Lq, S, heads, dk, dv)
        for ref in refs:
            _close(ours, ref)


@pytest.mark.parametrize("dk,dv,aligned,narrow", [
    (64, 64, True, False), (60, 60, True, False), (12, 136, True, False),
    (61, 61, True, True), (64, 62, True, True), (1, 1, True, True),
    (64, 64, False, True), (60, 60, False, True),
])
def test_f32_copy_width(rng, dk, dv, aligned, narrow):
    """The wrapper keeps 16-byte copies where q, k and v are aligned to 16
    bytes and d_k and d_v are multiples of 4 (every HCM call), and copies
    one float at a time elsewhere.  Where d is off a multiple of 4, a head's
    rows start off 16-byte boundaries, and where d_k is, 16-byte copies
    would also take the next head's first columns into the zero-filled tail
    of q and k, which the emulation shows against the plain version (past
    d_v those columns only reach outputs that are not stored)."""
    assert fused_attention.f32_narrow_copies(dk, dv, aligned) == narrow
    assert fused_attention.pick_route(torch.float32, 16, dk, dv, aligned) == "f32_tensor_core"
    if dk % 4 == 0:
        return
    N, Lq, S, heads = 2, 8, 16, 2
    q, k, v = _qkv(rng, N, Lq, S, heads * dk, heads * dv)
    bufs = [torch.from_numpy(a).flatten() for a in (q, k, v)]
    ref = fused_attention.attention_plain(*map(torch.from_numpy, (q, k, v)), heads)
    _close(_f32_kernel_emulation(bufs, (0, 0, 0), N, Lq, S, heads, dk, dv), ref)
    wide = _f32_kernel_emulation(bufs, (0, 0, 0), N, Lq, S, heads, dk, dv, narrow=False)
    assert (wide - ref).abs().max().item() > 1e-3


def test_tf32_rounding_is_round_half_away():
    """_tf32 keeps 10 mantissa bits, rounds to nearest, ties away from zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0], dtype=torch.float32)
    torch.testing.assert_close(
        _tf32(x), torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0]),
        atol=0, rtol=0)


@pytest.mark.parametrize("S,dk,dv,aligned,route,bf16_route", [
    (16, 64, 64, True, "f32_tensor_core", "bf16"), (64, 64, 64, True, "f32_tensor_core", "bf16"),
    (1, 8, 16, True, "f32_tensor_core", None), (128, 128, 128, True, "f32_tensor_core", "bf16"),
    (33, 128, 8, True, "f32_tensor_core", None), (16, 12, 12, True, "f32_tensor_core", None),
    (200, 64, 64, True, "f32_tensor_core", "bf16"), (16, 64, 136, True, "f32_tensor_core", None),
    (16, 64, 64, False, "f32_tensor_core", None),
    (16, 1, 1, True, "f32_tensor_core", None), (64, 61, 61, False, "f32_tensor_core", None),
    (16, 256, 256, True, "f32_tensor_core", None), (16, 256, 1, False, "f32_tensor_core", None),
    (16, 260, 260, True, "f32_cuda_core", None),  # above 256: PR 1's kernel
    (16, 64, 257, True, "f32_cuda_core", None),
])
def test_f32_attention_route(S, dk, dv, aligned, route, bf16_route):
    """float32 calls take the tensor-core route wherever it takes the sizes
    (any d_k and d_v from 1 to 256, any S, either alignment: the HCM's
    among them, S = 200 in key blocks, d off a multiple of 8 zero-filled,
    unaligned pointers by one-float copies) and the CUDA-core kernel only
    for d_k or d_v above 256, decided before the launch; bfloat16 calls take
    the bf16 kernel where it takes the sizes (d_k = d_v, a multiple of 16 up
    to 128, K and V within shared memory, aligned pointers) and raise before
    any launch elsewhere (``None``)."""
    assert fused_attention.pick_route(torch.float32, S, dk, dv, aligned) == route
    if bf16_route is None:
        with pytest.raises(ValueError, match="bfloat16 kernel"):
            fused_attention.pick_route(torch.bfloat16, S, dk, dv, aligned)
    else:
        assert fused_attention.pick_route(torch.bfloat16, S, dk, dv, aligned) == bf16_route
    assert fused_attention.smem_bytes(S, dk, dv, route=route) <= fused_attention.SMEM_LIMIT


@pytest.mark.parametrize("dtype,S,d,route", [
    (torch.bfloat16, 144, 64, "bf16"),  # the depth tokens of a 384 px frame
    (torch.bfloat16, 200, 64, "bf16"), (torch.bfloat16, 384, 128, "bf16"),
    (torch.bfloat16, 385, 128, "bf16"), (torch.bfloat16, 16, 256, None),
    (torch.bfloat16, 512, 128, "bf16"), (torch.bfloat16, 100_000, 128, "bf16"),
    (torch.bfloat16, 385, (128, 64), None),  # d_k != d_v
    (torch.float32, 420, 64, "f32_tensor_core"),  # key blocks
    (torch.float32, 500, 64, "f32_tensor_core"),
    (torch.float32, 7200, 64, "f32_tensor_core"), (torch.float32, 7201, 64, "f32_tensor_core"),
    (torch.bfloat16, 16, 64, "bf16"), (torch.bfloat16, 64, 64, "bf16"),  # the HCM's
    (torch.float32, 16, 64, "f32_tensor_core"), (torch.float32, 64, 64, "f32_tensor_core"),
    (torch.float32, 420, 60, "f32_tensor_core"),  # d zero-filled to 64
    (torch.float32, 500, 60, "f32_tensor_core"),
    (torch.float32, 7252, 12, "f32_tensor_core"), (torch.float32, 7253, 12, "f32_tensor_core"),
    (torch.float32, 200, 256, "f32_tensor_core"), (torch.float32, 100_000, 200, "f32_tensor_core"),
    (torch.float32, 200, 260, "f32_cuda_core"),  # K and V read in place
    (torch.float32, 6964, 300, "f32_cuda_core"), (torch.float32, 6965, 300, None),
])
def test_attention_route_past_128_keys(dtype, S, d, route):
    """Past S = 128 the bf16 kernel and the float32 tensor-core route stream
    their keys in key blocks, and both take every S; the float32 route takes
    every d up to 256.  The float32 CUDA-core kernel, for d above 256, reads
    K and V in place where they do not fit in shared memory and takes every
    S up to d + S = 7264; past that limit, and for bf16 with d_k != d_v
    (``d`` a pair), the call raises (``None``) before any launch.  The HCM's
    shapes take the tensor-core kernels."""
    dk, dv = d if isinstance(d, tuple) else (d, d)
    if route is None:
        with pytest.raises(ValueError, match="cross_modal_attn"):
            fused_attention.pick_route(dtype, S, dk, dv)
        return
    assert fused_attention.pick_route(dtype, S, dk, dv) == route
    assert fused_attention.smem_bytes(S, dk, dv, route=route) <= fused_attention.SMEM_LIMIT


@pytest.mark.parametrize("H,n_sm,ok", [
    (512, 132, True), (32, 132, True), (1024, 132, True),
    (556, 132, True),  # 4 x 139: 111 blocks of 5 units and one of 1
    (1028, 132, False), (30, 132, False),
    (512, 60, False),  # 9 units a block on a card of 60 SMs
])
def test_lstm_hidden_sizes(H, n_sm, ok):
    """The LSTM kernel takes every H a multiple of 4 up to 1024 that needs at
    most 8 units a block on the card's SMs, and the wrapper raises before
    any launch for the rest."""
    if ok:
        fused_lstm.check_shape(1, H, fused_lstm._units_per_block(H, n_sm))
    else:
        with pytest.raises(ValueError, match="lstm_seq"):
            fused_lstm.check_shape(1, H, fused_lstm._units_per_block(H, n_sm))


def test_f32_tensor_core_smem_fits():
    """Every shape the float32 tensor-core route takes fits one block's
    shared memory.  With the keys whole, S and D up to 128
    (f32tc_smem_bytes in csrc/cross_modal_attn.cu): max(d_k, d_v) rounded up
    to D = 32, 64 or 128 and S to 16, 32, 64 or 128 rows; the 128-row Q tile
    in rows of D + 8 floats; K and V split into tf32 hi and lo parts (rows
    of 2D + 8, and pairs of rows of 4D + 8) at every size but D = 128 with
    S > 64, where they stay as they are (rows of D + 8 and D + 4).  In key
    blocks, past S = 128 and at every S where D = 256
    (f32tc_blocks_smem_bytes, whose formula and key-block sizes are read
    from the source): the Q tile, one key block split, and the next key
    block as it is, in rows of D; key blocks of 32 keys up to D = 128 and of
    8 at D = 256, where the Q tile alone takes 135,168 bytes."""
    admitted = [(S, dk, dv) for S in range(1, 130) for dk in range(1, 260, 3)
                for dv in range(1, 260, 7)
                if fused_attention.tensor_core_f32_takes(S, dk, dv)]
    assert len(admitted) == 129 * 86 * 37
    assert max(fused_attention.smem_bytes(*s, route="f32_tensor_core")
               for s in admitted) <= fused_attention.SMEM_LIMIT
    assert not fused_attention.tensor_core_f32_takes(16, 257, 64)
    assert not fused_attention.tensor_core_f32_takes(0, 64, 64)
    assert fused_attention.smem_bytes(64, 64, 64) == 4 * (128 * 72 + 64 * 136 + 32 * 264)
    assert fused_attention.smem_bytes(5, 8, 16) == 4 * (128 * 40 + 16 * 72 + 8 * 136)
    assert fused_attention.smem_bytes(128, 64, 96) == 4 * (128 * 136 + 128 * 268)
    assert fused_attention.smem_bytes(65, 128, 8) == 4 * (128 * 136 + 128 * 268)
    assert fused_attention.smem_bytes(64, 61, 1) == fused_attention.smem_bytes(64, 64, 64)

    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kF32KeyChunks\w*) = (\d+);", src))
    assert consts == {"kF32KeyChunks": str(fused_attention.F32_KEY_CHUNKS),
                      "kF32KeyChunksD256": str(fused_attention.F32_KEY_CHUNKS_D256)}
    assert "constexpr int KC = D <= 128 ? kF32KeyChunks : kF32KeyChunksD256;" in src
    body = re.search(r"size_t f32tc_blocks_smem_bytes\(int D, int KC\) \{(.*?)\n\}", src, re.S)
    assert " ".join(body.group(1).split()) == (
        "return sizeof(float) * ((size_t)kF32Tile * (D + 8) + (size_t)8 * KC * (2 * D + 8) + "
        "(size_t)4 * KC * (4 * D + 8) + (size_t)16 * KC * D);")
    assert (fused_attention.F32_KEY_CHUNKS, fused_attention.F32_KEY_CHUNKS_D256) == (4, 1)
    for d in (32, 64, 128, 256):
        kc = fused_attention.f32_key_chunks(d)
        want = 4 * (128 * (d + 8) + 8 * kc * (2 * d + 8) + 4 * kc * (4 * d + 8) + 16 * kc * d)
        for S, dk, dv in ((129, d, d), (144, d, d // 2), (7201, d, d), (100_000, d // 2, d),
                          (129, d - 1, d - 3)):
            assert fused_attention.smem_bytes(S, dk, dv) == want <= fused_attention.SMEM_LIMIT
    assert fused_attention.smem_bytes(144, 64, 64) == 87_552  # 2 blocks an SM
    assert fused_attention.smem_bytes(200, 128, 128) == 169_472
    # D = 256 in key blocks at every S, one block an SM; 16-key blocks would not fit
    for S, dk, dv in ((1, 256, 256), (16, 129, 8), (200, 256, 256), (5, 60, 136)):
        assert fused_attention.smem_bytes(S, dk, dv) == 184_704
    assert 4 * (128 * 264 + 16 * 520 + 8 * 1032 + 32 * 256) > fused_attention.SMEM_LIMIT


def test_bf16_key_block_smem_fits():
    """Past S = 128 the bf16 key blocks need the same shared memory at every
    S (bf16_blocks_smem_bytes in csrc/cross_modal_attn.cu, its formula and
    constants read from the source): the 64-row Q tile and the ring's 3
    stages of K and V of 32 keys, in rows of d + 8 values, within one
    block's limit at every head size the route takes."""
    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    consts = {name: int(value) for name, value in re.findall(
        r"constexpr int (kBf16BlockWarps|kBf16KeyChunks|kBf16Stages) = (\d+);", src)}
    assert consts == {"kBf16BlockWarps": fused_attention.BF16_BLOCK_WARPS,
                      "kBf16KeyChunks": fused_attention.BF16_KEY_CHUNKS,
                      "kBf16Stages": fused_attention.BF16_STAGES} == {
        "kBf16BlockWarps": 4, "kBf16KeyChunks": 2, "kBf16Stages": 3}
    body = re.search(r"size_t bf16_blocks_smem_bytes\(int D\) \{(.*?)\n\}", src, re.S)
    assert " ".join(body.group(1).split()) == (
        "return sizeof(__nv_bfloat16) * (D + kPad) * "
        "(16 * kBf16BlockWarps + 2 * kBf16Stages * 16 * kBf16KeyChunks);")
    for d in range(16, 129, 16):
        want = 2 * (d + 8) * (16 * 4 + 2 * 3 * 16 * 2)
        sizes = {fused_attention.smem_bytes(S, d, d, torch.bfloat16)
                 for S in (129, 144, 200, 385, 512, 1000, 100_000)}
        assert sizes == {want} and want <= fused_attention.SMEM_LIMIT
    assert fused_attention.smem_bytes(144, 64, 64, torch.bfloat16) == 36_864
    assert fused_attention.smem_bytes(200, 128, 128, torch.bfloat16) == 69_632


def test_attention_route_codes_match_the_c_entry():
    """The wrapper's route codes are the C entry's, F32_KEY_BLOCKS is the
    code of the float32 key-block kernel, which takes d up to F32_MAX_D
    against F32_WHOLE_MAX_D for the whole-key kernel, one-float copies are
    for those two codes only, and the C entry's whole-key float32 instances
    end at F32_WHOLE_S, past which the wrapper sends the key blocks."""
    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    entry = src[src.index('extern "C" int cross_modal_attn('):]
    assert fused_attention.ROUTES == {"f32_cuda_core": 0, "bf16": 1, "f32_tensor_core": 2}
    assert "if (route == 0) return launch_f32(" in entry
    assert f"if ((route == 1 || route == {fused_attention.BF16_KEY_BLOCKS}) && dk == dv" in entry
    blocks = fused_attention.F32_KEY_BLOCKS
    assert f"const int d_max = route == {blocks} ? {fused_attention.F32_MAX_D} : " \
           f"{fused_attention.F32_WHOLE_MAX_D};" in entry
    assert f"if ((route == 2 || route == {blocks}) && dk >= 1 && dv >= 1" in entry
    assert f"dk, dv, route == {blocks}, narrow != 0, s);" in entry
    assert "if (narrow && route != 2 && route != 3) return (int)cudaErrorInvalidValue;" in entry
    whole = re.findall(r"if \(S <= (\d+)\)\s+return launch_f32tc_tiles<D, (\d+), kNarrow>", src)
    assert [(int(S), int(kc)) for S, kc in whole] == [(16, 2), (32, 4), (64, 8), (128, 16)]
    assert int(whole[-1][0]) == fused_attention.F32_WHOLE_S


def test_bf16_route_codes_match_the_c_entry():
    """BF16_KEY_BLOCKS is the C entry's code of the bf16 key-block kernel,
    which the entry hands to launch_bf16_any as key_blocks, with the mode of
    p (round_p, for the bf16 codes only), and the entry's whole-key bf16
    instances, in either mode, end at BF16_WHOLE_S, past which the wrapper
    sends the key blocks."""
    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    entry = src[src.index('extern "C" int cross_modal_attn('):]
    code = fused_attention.BF16_KEY_BLOCKS
    assert code not in fused_attention.ROUTES.values()
    assert code != fused_attention.F32_KEY_BLOCKS
    assert f"if ((route == 1 || route == {code}) && dk == dv && S >= 1)" in entry
    assert (f"launch_bf16_any(q, k, v, out, N, Lq, S, heads, dk, route == {code}, "
            "round_p != 0, s);") in entry
    assert f"if (round_p && route != 1 && route != {code}) return (int)cudaErrorInvalidValue;" \
        in entry
    assert "if (round_p) return launch_bf16_mode<true>(" in src
    whole = re.findall(r"if \(S <= (\d+)\) return launch_bf16_tiles<D, (\d+), kRoundP>", src)
    assert [(int(S), int(kc)) for S, kc in whole] == [(16, 1), (32, 2), (64, 4), (128, 8)]
    assert int(whole[-1][0]) == fused_attention.BF16_WHOLE_S
    assert fused_attention.BF16_P_MODES == ("round_p", "split_p")


def test_attention_entry_takes_the_mode(monkeypatch):
    """The C entry's arguments: q, k, v, out, then N, Lq, S, heads, dk, dv,
    route, narrow and round_p, then the stream; set once."""
    class Lib:
        cross_modal_attn = type("Fn", (), {})()

    monkeypatch.setattr(_build, "load", lambda name: Lib)
    fused_attention._entry.cache_clear()
    try:
        assert fused_attention._entry() is Lib.cross_modal_attn
        assert Lib.cross_modal_attn.argtypes == (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    finally:
        fused_attention._entry.cache_clear()
    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    assert ("int dk, int dv, int route, int narrow, int round_p,\n"
            "                                void* stream) {") in src


def test_f32_attention_on_cpu_launches_nothing(rng):
    """A float32 call on CPU tensors at the HCM's head layout runs the plain
    version and launches no kernel of any route."""
    q, k, v = map(torch.from_numpy, _qkv(rng, 2, 16, 16, 256, 256))
    fused_attention.reset_launches()
    out = fused_attention.fused_cross_modal_attention(q, k, v, 4)
    assert fused_attention.launches == 0
    assert not any(fused_attention.route_launches.values())
    torch.testing.assert_close(out, fused_attention.attention_plain(q, k, v, 4),
                               atol=0, rtol=0)


def test_masked_attention_takes_plain_path(rng, monkeypatch):
    """A masked call, or one that asks for the weights, never reaches the
    kernel's wrapper; -1e30 fill before the softmax and zero after it, so a
    fully masked row gives zeros, as in JAX."""
    q, k, v = _qkv(rng, 2, 8, 8, 64, 64)
    mask = np.zeros((2, 1, 8, 8), bool)
    mask[:, :, :, 6:] = True
    mask[1, :, 3, :] = True  # a fully masked row

    def refuse(*a, **kw):
        raise AssertionError("masked call reached the kernel wrapper")

    monkeypatch.setattr(fused_attention, "fused_cross_modal_attention", refuse)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out = cm_attention.attention_core(tq, tk, tv, 2, torch.from_numpy(mask))
    ref = jax_cm.mha_attention(*map(jnp.asarray, (q, k, v)), 2, jnp.asarray(mask))
    _close(out, ref)
    assert np.all(out.numpy()[1, 3] == 0.0)
    out_w, weights = cm_attention.attention_core(tq, tk, tv, 2, return_weights=True)
    ref_w, ref_weights = jax_cm.mha_attention(
        *map(jnp.asarray, (q, k, v)), 2, return_weights=True)
    _close(out_w, ref_w)
    _close(weights, ref_weights)


def test_wrappers_refuse_non_cuda_tensors(rng):
    """The launch functions take CUDA tensors only: they never run the plain
    version in place of the kernel."""
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 4, 4, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.cross_modal_attn_cuda(q, k, v, 2)
    args = map(torch.from_numpy, _lstm_inputs(rng, 2, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_lstm.lstm_seq_cuda(*args)
    args = list(map(torch.from_numpy, _lstm_inputs(rng, 2, 1, 8)))
    outs = lstm_recurrence(*args)[0]
    fused_lstm.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        fused_lstm.lstm_seq_backward_cuda(*args, outs, outs, args[2], args[3])
    assert fused_lstm.backward_launches == 0


def test_bf16_attention_route(rng):
    """A bf16 call the kernel would not take (d = 24) still runs the plain
    version on CPU tensors; the launch function refuses CPU tensors, and the
    bf16 route's range check refuses d = 24 before any launch."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 2, 8, 6, 48, 48))
    fused_attention.reset_launches()
    out = fused_attention.fused_cross_modal_attention(q, k, v, 2)
    assert fused_attention.launches == 0
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, fused_attention.attention_plain(q, k, v, 2), atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_attention.cross_modal_attn_cuda(q, k, v, 2)
    with pytest.raises(ValueError, match="bfloat16 kernel takes"):
        fused_attention.check_bf16_route(6, 24, 24)


@pytest.mark.parametrize("S,dk,dv,ok", [
    (16, 64, 64, True), (64, 64, 64, True), (1, 16, 16, True), (128, 128, 128, True),
    (33, 32, 32, True), (129, 64, 64, True), (16, 64, 32, False), (16, 144, 144, False),
    (16, 8, 8, False), (384, 128, 128, True), (385, 128, 128, True),
    (385, 128, 64, False),  # d_k != d_v
    (1000, 64, 64, True), (200, 128, 128, True), (200, 120, 120, False),
])
def test_bf16_route_range(S, dk, dv, ok):
    if ok:
        fused_attention.check_bf16_route(S, dk, dv)
        assert (fused_attention.smem_bytes(S, dk, dv, torch.bfloat16)
                <= fused_attention.SMEM_LIMIT)
    else:
        with pytest.raises(ValueError):
            fused_attention.check_bf16_route(S, dk, dv)


def test_kernel_library_names_follow_sources():
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").is_file()


def test_kernel_functions_backward_replays_plain(rng, monkeypatch):
    """The autograd.Functions around the kernels give the plain versions'
    gradients: the LSTM's backward launches its own kernel, attention's
    replays the plain version, as the JAX custom VJPs replay theirs.  The
    launch functions, the LSTM's forward and backward both, are stood in
    for by the plain versions, since the kernels run only on the card; the
    LSTM's gradients (the masks' included) are held against autograd
    through lstm_recurrence."""
    monkeypatch.setattr(fused_lstm, "lstm_seq_cuda", lstm_recurrence)
    monkeypatch.setattr(fused_lstm, "lstm_seq_backward_cuda", lstm_recurrence_backward)
    monkeypatch.setattr(fused_attention, "cross_modal_attn_cuda", fused_attention.attention_plain)
    cases = [
        (fused_lstm._FusedLSTM.apply, lstm_recurrence, _lstm_inputs(rng, 4, 2, 8), ()),
        (fused_attention._FusedAttention.apply, fused_attention.attention_plain,
         _qkv(rng, 2, 6, 5, 16, 16), (2,)),
    ]
    for fn, plain, arrays, extra in cases:
        grads = []
        for f in (fn, plain):
            inputs = [torch.tensor(a, requires_grad=True) for a in arrays]
            out = f(*inputs, *extra)
            outs = out if isinstance(out, tuple) else (out,)
            sum((o * o).sum() for o in outs).backward()
            grads.append([t.grad for t in inputs])
        for g, r in zip(*grads):
            torch.testing.assert_close(g, r, atol=1e-6, rtol=0)


def test_attention_function_grads_keep_input_dtype(rng, monkeypatch):
    """A bfloat16 forward's backward replays the plain version in the
    round_p mode (mha_attention on the bf16 inputs, the function JAX
    differentiates); the gradients of q, k and v come back in bfloat16,
    their inputs' dtype, and equal the plain version's own."""
    monkeypatch.setattr(fused_attention, "cross_modal_attn_cuda", fused_attention.attention_plain)
    arrays = _qkv(rng, 2, 6, 5, 32, 32)
    grads = []
    for fn in (fused_attention._FusedAttention.apply, fused_attention.attention_plain):
        inputs = [torch.tensor(a).to(torch.bfloat16).requires_grad_() for a in arrays]
        fn(*inputs, 2).float().square().sum().backward()
        assert all(t.grad.dtype == torch.bfloat16 for t in inputs)
        grads.append([t.grad for t in inputs])
    for g, r in zip(*grads):
        torch.testing.assert_close(g, r, atol=0, rtol=0)


@pytest.mark.parametrize("H,B,fits", [
    (512, 4, True), (512, 20, True), (1024, 28, True), (1024, 29, False), (512, 57, False),
])
def test_lstm_smem_bound(H, B, fits):
    """Two buffers of h with B rounded up to 2 rows, in float32
    (lstm_seq_smem_bytes in csrc/lstm_seq.cu); W_hh's rows are in registers."""
    assert (fused_lstm.smem_bytes(H, B) <= fused_lstm.SMEM_LIMIT) == fits
    assert fused_lstm.smem_bytes(H, B) == 4 * 2 * (-(-B // 2) * 2) * H


def _lstm_kernel_emulation(gates_x, masks, h0, c0, w_hh):
    """csrc/lstm_seq.cu's arithmetic in plain float32 torch.  Per step, lane l
    of a warp sums the 16-byte chunks l, l+32, ... of h · W_hh (the four
    values of a chunk in turn), the 32 lanes' partial sums meet in an
    xor-shuffle tree (offsets 16, 8, 4, 2, 1), the mask multiplies the
    product and c, and the gates follow in torch's order, the activations
    written through exp as the kernel writes them."""
    T, B, four_h = gates_x.shape
    H = four_h // 4
    k_pad = -(-H // 128) * 128  # chunks past H are a lane's zeros
    w = torch.zeros(k_pad, four_h)
    w[:H] = w_hh
    w = w.view(k_pad // 128, 32, 4, four_h)  # k = 128·j + 4·lane + i
    lanes = torch.arange(32)

    def sigmoid(x):
        return 1.0 / (1.0 + torch.exp(-x))

    def tanh(x):
        return 1.0 - 2.0 / (torch.exp(2.0 * x) + 1.0)

    h, c = h0, c0
    outs = []
    for t in range(T):
        hp = torch.zeros(B, k_pad)
        hp[:, :H] = h
        hp = hp.view(B, k_pad // 128, 32, 4)
        acc = torch.zeros(B, 32, four_h)
        for j in range(k_pad // 128):
            for i in range(4):
                acc = acc + hp[:, j, :, i, None] * w[None, j, :, i]
        for off in (16, 8, 4, 2, 1):
            acc = acc + acc[:, lanes ^ off]
        m = masks[t][:, None]
        g = gates_x[t] + m * acc[:, 0]
        gi, gf, gg, go = g.chunk(4, dim=-1)
        c = sigmoid(gf) * (c * m) + sigmoid(gi) * tanh(gg)
        h = sigmoid(go) * tanh(c)
        outs.append(h)
    return torch.stack(outs), h, c


@pytest.mark.parametrize("T,B,H", [(50, 4, 512), (7, 11, 64), (5, 20, 64), (3, 9, 32),
                                   (4, 3, 556)])
def test_lstm_kernel_summation_order_matches_jax(rng, T, B, H):
    """The kernel's K-slicing and reduction tree, through a window with a
    reset inside it (masks as chip_smoke.py makes them), against the JAX
    scan and the interpret-mode Pallas kernel (H = 556: a partial last
    chunk of lanes, at the size whose grid has a ragged last block)."""
    args = _lstm_inputs(rng, T, B, H)
    args[1][0] = 1.0
    args[1][0, 1::2] = 0.0  # odd rows reset at t=0, even rows go on from h0, c0
    ours = _lstm_kernel_emulation(*map(torch.from_numpy, args))
    scan = jax_lstm._scan_impl(*map(jnp.asarray, args))
    pallas = jax_lstm._pallas_lstm_call(*map(jnp.asarray, args), interpret=True)
    for o, s, p in zip(ours, scan, pallas):
        _close(o, s)
        _close(o, p)


@pytest.mark.parametrize("B,H,units,ok", [
    (4, 512, 4, True), (8, 512, 4, True), (20, 512, 4, True), (1, 32, 1, True),
    (11, 64, 1, True), (56, 512, 4, True), (65, 512, 4, False), (4, 30, 1, False),
    (4, 66, 1, False), (4, 1024, 8, True), (33, 1024, 8, False), (4, 1028, 8, False),
    (4, 996, 12, False), (256, 64, 1, True), (257, 64, 1, False), (4, 48, 3, True),
    (65, 48, 3, False),
])
def test_lstm_shape_range(B, H, units, ok):
    """The wrapper refuses before any launch what one launch of the kernel
    does not take: H off a multiple of 4 or above 1024, more than 8 units a
    block, more than 16 batch pairs a warp, or more shared memory than a
    block has."""
    if ok:
        fused_lstm.check_shape(B, H, units)
    else:
        with pytest.raises(ValueError, match="lstm_seq"):
            fused_lstm.check_shape(B, H, units)


@pytest.mark.parametrize("B,H,units,slices", [
    (4, 512, 4, [(0, 4)]), (56, 512, 4, [(0, 56)]), (60, 512, 4, [(0, 30), (30, 60)]),
    (113, 512, 4, [(0, 38), (38, 76), (76, 113)]), (29, 1024, 8, [(0, 15), (15, 29)]),
    (300, 64, 1, [(0, 150), (150, 300)]), (1, 32, 1, [(0, 1)]),
])
def test_lstm_batch_slices(B, H, units, slices):
    """A batch beyond one launch runs as launches over equal slices of rows,
    each of which one launch takes."""
    assert fused_lstm.batch_slices(B, H, units) == slices
    for b0, b1 in slices:
        fused_lstm.check_shape(b1 - b0, H, units)


def test_lstm_by_rows_matches_jax(rng):
    """Rows run in slices and joined give the whole batch's outs, hT and cT
    (to the matmul's summation order, which depends on the batch)."""
    args = _lstm_inputs(rng, 6, 7, 16)
    whole = lstm_recurrence(*map(torch.from_numpy, args))
    sliced = fused_lstm.by_rows(lstm_recurrence, [(0, 3), (3, 6), (6, 7)],
                                *map(torch.from_numpy, args))
    scan = jax_lstm._scan_impl(*map(jnp.asarray, args))
    for s, w, j in zip(sliced, whole, scan):
        _close(s, w)
        _close(s, j)


def test_lstm_entry_set_up_once(monkeypatch):
    """The kernel's library is loaded and its C entries' argument types set
    once; later calls reuse them."""
    loads = []

    class Lib:
        lstm_seq_f32 = type("Fn", (), {})()
        lstm_seq_exchange = type("Fn", (), {})()

    def load(name):
        loads.append(name)
        return Lib

    monkeypatch.setattr(_build, "load", load)
    fused_lstm._entry.cache_clear()
    fused_lstm._exchange_entry.cache_clear()
    try:
        fns = [fused_lstm._entry() for _ in range(3)]
        assert all(f is Lib.lstm_seq_f32 for f in fns)
        assert fused_lstm._exchange_entry() is Lib.lstm_seq_exchange
        assert loads == ["lstm_seq", "lstm_seq"]
        assert len(Lib.lstm_seq_f32.argtypes) == 15
        assert len(Lib.lstm_seq_exchange.argtypes) == 7
    finally:
        fused_lstm._entry.cache_clear()
        fused_lstm._exchange_entry.cache_clear()


@pytest.mark.parametrize("S,d,fits", [(16, 64, True), (64, 64, True), (512, 128, False)])
def test_attention_smem_bound(S, d, fits):
    """Both routes' shared memory a block: float32 on the CUDA cores K and V
    where they fit (else read in place), a q row and S probabilities a
    warp; bfloat16 up to S = 128 the 64-row Q tile, K and V with S rounded
    up to 16, past it the 64-row Q tile and the ring's 3 stages of 32 keys,
    in rows of d + 8 values, within the limit at every S.  ``fits``:
    whether float32 K and V fit."""
    staged = 4 * (S * (d + 1) + S * d + 8 * (d + S))
    assert fused_attention.smem_bytes(S, d, d, route="f32_cuda_core") == (
        staged if fits else 4 * 8 * (d + S))
    bf16 = fused_attention.smem_bytes(S, d, d, torch.bfloat16)
    assert bf16 <= fused_attention.SMEM_LIMIT
    rows = 64 + 2 * (-(-S // 16) * 16) if S <= 128 else 64 + 2 * 3 * 32
    assert bf16 == 2 * (d + 8) * rows
