"""bf16 attention's probabilities p against the JAX package's two settings
of TPU.PALLAS_ATTENTION (the port's ops/cm_attention.set_float32_probabilities).

Off, the default in both packages: the JAX attention is XLA's
``mha_attention``, which rounds the normalised p to bf16 before p·v
(robo_vln_tpu/ops/cm_attention.py:102).  The port's plain version, its
``attention_core`` on CPU tensors and an emulation of the whole-key bf16
kernel's ``round_p`` arithmetic (tests/test_torch_ops.py::_p_split_attention
with ``keep_lo`` False) agree with it to one bf16 ulp of the output, plus
one bf16 ulp of the output's largest term where a rounding of p flips
(tests/test_torch_ops.py::_round_p_tolerance: the two float32 softmaxes
differ in their last bits; the p split exceeds that bound by 1.1-2.1
times); at the HCM shapes (N=4, Lq=200, d = 64, S = 16 and 64, numpy seed
0) 0.0005% and 0.004% of the outputs differ at all, where the p split
(``split_p``, what the port computed before this setting) differs in about
41% of them.  The key-block kernel (S > 128)
rounds p against its lazy reference max, before p is normalised: each of
the two roundings moves a key's term by at most 2^-9 of it, so its
emulation is held to 2^-8 max|v| plus one ulp of the output.  On, the JAX
package's Pallas kernel keeps p in float32: that case is
tests/test_torch_ops.py::test_attention_plain_bf16_matches_pallas.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.models import build_hierarchical_policies as jax_build
from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn
from robo_vln_tpu.ops import cm_attention as jax_cm
from robo_vln_tpu_torch import build_hcm_agent
from robo_vln_tpu_torch.ops import cm_attention, fused_attention
from tests.test_torch_agent import B, _to_torch, jax_tiny_hcm, make_inputs
from tests.test_torch_ops import (ATTN_SHAPES, _bf16_ulp, _p_split_attention,
                                  _p_split_attention_blocks, _qkv, _round_p_tolerance)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HCM_SHAPES = [(4, 200, 16, 256, 256, 4), (4, 200, 64, 256, 256, 4)]  # N, Lq, S, D, Dv, h
WINDOW_TOL = 1e-2  # a bf16 window: the packages round at other places, 2^-9 each


@contextlib.contextmanager
def _jax_pallas(enabled):
    saved = jax_cm.use_pallas()
    jax_cm.set_use_pallas(enabled)
    try:
        yield
    finally:
        jax_cm.set_use_pallas(saved)


@contextlib.contextmanager
def _float32_probabilities(enabled):
    saved = cm_attention.float32_probabilities()
    cm_attention.set_float32_probabilities(enabled)
    try:
        yield
    finally:
        cm_attention.set_float32_probabilities(saved)


def _bf16_inputs(rng, N, Lq, S, D, Dv):
    """(jax bf16, torch bf16) q, k, v of the same values."""
    j = [jnp.asarray(a).astype(jnp.bfloat16) for a in _qkv(rng, N, Lq, S, D, Dv)]
    t = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in j]
    return j, t


def _jax_default(jq, jk, jv, heads):
    with _jax_pallas(False):
        return np.asarray(jax_cm.attention_core(jq, jk, jv, heads).astype(jnp.float32))


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("N,Lq,S,D,Dv,heads", HCM_SHAPES + ATTN_SHAPES)
def test_default_p_matches_jax_default(rng, N, Lq, S, D, Dv, heads):
    """With the setting at its default: the port's attention_core (CPU
    tensors: the plain version), attention_plain and the whole-key kernel's
    round_p emulation, rounded to bf16, each within one bf16 ulp of JAX's
    attention_core with set_use_pallas(False), plus a flipped rounding of p
    (_round_p_tolerance)."""
    (jq, jk, jv), (q, k, v) = _bf16_inputs(rng, N, Lq, S, D, Dv)
    ref = _jax_default(jq, jk, jv, heads)
    assert not cm_attention.float32_probabilities()
    core = cm_attention.attention_core(q, k, v, heads)
    assert core.dtype == torch.bfloat16
    plain = fused_attention.attention_plain(q, k, v, heads)
    kernel = _p_split_attention(q, k, v, heads, keep_lo=False).to(torch.bfloat16)
    for got in (core, plain, kernel):
        got = _f32(got)
        assert np.all(np.abs(got - ref) <= _round_p_tolerance(got, ref, jq, jk, jv, heads))


@pytest.mark.parametrize("S", [16, 64])
def test_default_p_differs_from_jax_far_less_than_the_split(rng, S):
    """At the HCM shapes (N=4, Lq=200, d=64, 4 heads) the share of outputs
    that differ from JAX's default at all: the port's default under 0.1%
    (0.0005% at S=16, 0.004% at S=64), the p split (JAX's Pallas kernel's
    function, and the port's only one before the setting) over 30% (about
    41%), so the default is over 100 times closer."""
    (jq, jk, jv), (q, k, v) = _bf16_inputs(rng, 4, 200, S, 256, 256)
    ref = _jax_default(jq, jk, jv, 4)
    rounded = np.mean(_f32(fused_attention.attention_plain(q, k, v, 4)) != ref)
    split = np.mean(_f32(fused_attention.attention_plain(q, k, v, 4, float32_p=True)) != ref)
    assert rounded < 1e-3 and split > 0.3
    assert 100 * rounded < split


@pytest.mark.parametrize("S,d", [
    pytest.param(129, 64, id="129"), pytest.param(144, 64, id="144"),
    pytest.param(300, 64, id="300"), pytest.param(512, 128, id="512-d128"),
    pytest.param(1000, 64, id="1000"),
])
def test_key_block_round_p_within_its_bound(rng, S, d):
    """The key-block kernel's round_p emulation (unnormalised p rounded to
    bf16 against the lazy reference max, divided by the float32 sum at the
    end), rounded to bf16, against JAX's default: within 2^-8 max|v| (the
    two rounding points, 2^-9 of each key's term each) plus one bf16 ulp of
    the output."""
    (jq, jk, jv), (q, k, v) = _bf16_inputs(rng, 2, 24, S, 2 * d, 2 * d)
    ref = _jax_default(jq, jk, jv, 2)
    got = _f32(_p_split_attention_blocks(q, k, v, 2, keep_lo=False).to(torch.bfloat16))
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
    bound = 2.0 ** -8 * v.float().abs().max().item()
    assert np.all(np.abs(got - ref) <= bound + ulp)


def test_setting_picks_the_plain_function(rng):
    """Off by default; on, a bf16 call of the plain version (and of
    attention_core on CPU tensors) is the float32 function rounded once,
    the function the interpret-mode Pallas kernel computes; float32 calls
    are the same either way."""
    (_, _, _), (q, k, v) = _bf16_inputs(rng, 2, 16, 16, 64, 64)
    split = fused_attention.attention_plain(q, k, v, 2, float32_p=True)
    rounded = fused_attention.attention_plain(q, k, v, 2, float32_p=False)
    assert not torch.equal(split, rounded)
    f32 = [t.float() for t in (q, k, v)]
    for enabled, want in ((True, split), (False, rounded)):
        with _float32_probabilities(enabled):
            assert fused_attention.p_mode() == ("split_p" if enabled else "round_p")
            assert torch.equal(fused_attention.attention_plain(q, k, v, 2), want)
            assert torch.equal(cm_attention.attention_core(q, k, v, 2), want)
            torch.testing.assert_close(fused_attention.attention_plain(*f32, 2),
                                       fused_attention.attention_plain(*f32, 2, float32_p=False),
                                       atol=0, rtol=0)
    assert fused_attention.p_mode() == "round_p"


def test_bf16_hcm_window_matches_jax_on_defaults():
    """A tiny bf16 HCM window (tests/test_torch_agent.py's tiny configs and
    weights) through both packages with TPU.PALLAS_ATTENTION at its default:
    every output within WINDOW_TOL of JAX's (largest outputs about 1)."""
    jax_mc, port_mc, _, _, high_vars, low_vars = jax_tiny_hcm()
    high, low = jax_build(jax_mc, compute_dtype=jnp.bfloat16)
    trunk_fn = jax_trunk_fn(jax_mc, jnp.bfloat16, {"batch_stats": high_vars["batch_stats"]})

    def step(hv, lv, obs, masks, hh, lh):
        obs = {**obs, **trunk_fn(hv["params"], obs)}
        logits, hh = high.apply(hv, obs, hh, None, masks)
        actions, stop, lh = low.apply(lv, obs, lh, None, masks, jnp.argmax(logits, -1))
        return actions, stop, logits, hh, lh

    obs, masks = make_inputs(np.random.default_rng(3))
    with _jax_pallas(False):
        ref = jax.jit(step)(high_vars, low_vars, jax.tree.map(jnp.asarray, obs),
                            jnp.asarray(masks), high.initial_hidden(B), low.initial_hidden(B))
    agent = build_hcm_agent(port_mc, device="cpu", compute_dtype="bfloat16",
                            weights=(high_vars, low_vars))
    assert not cm_attention.float32_probabilities()
    got = agent.forward_window(_to_torch(obs), torch.from_numpy(masks), None,
                               *agent.initial_state(B))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(_f32(g), np.asarray(r, np.float32), atol=WINDOW_TOL)
