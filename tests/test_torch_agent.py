"""The port's HCM serving path end to end against the JAX package.

A tiny JAX HCM is built the way __graft_entry__._hcm_setup(..., tiny=True)
builds it, with ResNet stages cut to one block each; its variables are drawn
from a numpy seed, the low level's frozen trunks are synced to the high
level's, and utils/weight_port.py carries them into the port.  The port's
``forward_window`` must equal the JAX entry()-style forward (shared trunks,
high level, argmax, low level), and three closed-loop ``act`` ticks with the
cached BERT embedding must equal JAX single-step applies, within 1e-4 in f32
(the tolerance of test_hierarchical_converter_forward_parity).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.models import build_hierarchical_policies as jax_build
from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn
from robo_vln_tpu.models import sync_frozen_trunks as jax_sync
from robo_vln_tpu_torch import build_hcm_agent
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.ops import fused_attention, fused_lstm

ATOL = 1e-4
B, T, L, PX = 2, 3, 16, 64

# the tiny sizes of __graft_entry__._hcm_setup(tiny=True), one block a stage
TINY = {
    "BERT.num_layers": 2, "BERT.hidden_size": 32, "BERT.num_heads": 2,
    "BERT.intermediate_size": 64, "BERT.vocab_size": 64,
    "VISUAL_LING_ATTN.ins_in_features": 32, "VISUAL_LING_ATTN.d_model": 16,
    "VISUAL_LING_ATTN.d_ff": 32, "VISUAL_LING_ATTN.h": 2,
    "STATE_ENCODER.hidden_size": 32, "RGB_ENCODER.output_size": 16,
    "DEPTH_ENCODER.output_size": 8,
    "RGB_ENCODER.blocks": [1, 1, 1, 1], "DEPTH_ENCODER.blocks": [1, 1, 1, 1],
}


def _set(mc, overrides):
    for key, value in overrides.items():
        node = mc
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return mc


def tiny_configs(depth_px=PX):
    """(JAX MODEL config, port MODEL config) with the same tiny sizes."""
    jax_mc = _set(jax_get_config().clone().defrost().MODEL, TINY)
    port_mc = _set(get_config().clone().defrost().MODEL,
                   {**TINY, "DEPTH_ENCODER.input_size": depth_px})
    return jax_mc, port_mc


def random_variables(shapes, seed):
    """Numpy variables for a flax variable tree of ``jax.eval_shape`` leaves,
    scaled like an initialised network (lecun kernels, non-trivial biases,
    norm scales and BatchNorm statistics)."""
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if name == "kernel" or name in ("w_ih", "w_hh"):
            return rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * rng.standard_normal(shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, shape)
        return 0.1 * rng.standard_normal(shape)

    def fill(path, leaf):
        return draw(path[-1].key, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def make_inputs(rng, b=B, t=T):
    obs = {
        "rgb": rng.integers(0, 255, (b, t, PX, PX, 3)).astype(np.uint8),
        "depth": rng.random((b, t, PX, PX, 1)).astype(np.float16),
        "instruction": rng.integers(1, 60, (b, L)).astype(np.int32),
    }
    masks = np.ones((b, t), np.float32)
    masks[:, 0] = 0.0
    masks[-1, t // 2 + 1] = 0.0  # an episode boundary inside the window
    return obs, masks


@functools.lru_cache(maxsize=None)
def jax_tiny_hcm():
    """(jax_mc, port_mc, high, low, high_vars, low_vars) with synced trunks."""
    jax_mc, port_mc = tiny_configs()
    jax_mc.freeze()
    high, low = jax_build(jax_mc)
    obs, masks = make_inputs(np.random.default_rng(0))
    obs = jax.tree.map(jnp.asarray, obs)
    prev = jnp.zeros((B, T, 2))
    high_shapes = jax.eval_shape(high.init, jax.random.PRNGKey(0), obs,
                                 high.initial_hidden(B), prev, jnp.asarray(masks))
    low_shapes = jax.eval_shape(low.init, jax.random.PRNGKey(1), obs,
                                low.initial_hidden(B), prev, jnp.asarray(masks),
                                jnp.zeros((B, T), jnp.int32))
    high_vars = random_variables(high_shapes, 1)
    low_vars = jax_sync(high_vars, random_variables(low_shapes, 2))
    return jax_mc, port_mc, high, low, high_vars, low_vars


def _jax_step_fn(mc, high, low, high_vars):
    trunk_fn = jax_trunk_fn(mc, jnp.float32, {"batch_stats": high_vars["batch_stats"]})

    @jax.jit
    def step(hv, lv, obs, masks, hh, lh):
        obs = {**obs, **trunk_fn(hv["params"], obs)}
        logits, hh = high.apply(hv, obs, hh, None, masks)
        actions, stop, lh = low.apply(lv, obs, lh, None, masks, jnp.argmax(logits, -1))
        return actions, stop, logits, hh, lh

    return step


def _port_agent():
    _, port_mc, _, _, high_vars, low_vars = jax_tiny_hcm()
    return build_hcm_agent(port_mc, device="cpu", compute_dtype="float32",
                           weights=(high_vars, low_vars))


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=ATOL)


def test_forward_window_matches_jax_entry():
    jax_mc, _, high, low, high_vars, low_vars = jax_tiny_hcm()
    agent = _port_agent()
    assert agent.trunk_fn is not None  # synced trunks take the shared path
    obs, masks = make_inputs(np.random.default_rng(3))
    step = _jax_step_fn(jax_mc, high, low, high_vars)
    ref = step(high_vars, low_vars, jax.tree.map(jnp.asarray, obs), jnp.asarray(masks),
               high.initial_hidden(B), low.initial_hidden(B))
    fused_lstm.reset_launches()
    fused_attention.reset_launches()
    hh, lh = agent.initial_state(B)
    got = agent.forward_window(_to_torch(obs), torch.from_numpy(masks), None, hh, lh)
    assert fused_lstm.launches == 0 and fused_attention.launches == 0  # CPU: plain
    assert got[2].shape == (B, T, 4) and got[0].shape == (B, T, 2)
    for g, r in zip(got, ref):
        _close(g, r)


def test_closed_loop_ticks_match_jax_single_step():
    jax_mc, _, high, low, high_vars, low_vars = jax_tiny_hcm()
    agent = _port_agent()
    obs, masks = make_inputs(np.random.default_rng(4))
    step = _jax_step_fn(jax_mc, high, low, high_vars)
    emb = high.apply(high_vars, jnp.asarray(obs["instruction"]), method="embed_instruction")
    hh, lh = high.initial_hidden(B), low.initial_hidden(B)
    state = agent.initial_state(B)
    embeddings = []
    for t in range(T):
        tick = {"rgb": obs["rgb"][:, t], "depth": obs["depth"][:, t],
                "instruction": obs["instruction"]}
        j_tick = {**jax.tree.map(jnp.asarray, tick), "instruction_embedding": emb}
        actions_r, stop_r, _, hh, lh = step(high_vars, low_vars, j_tick,
                                            jnp.asarray(masks[:, t]), hh, lh)
        actions, stop, state = agent.act(_to_torch(tick), state, None,
                                         torch.from_numpy(masks[:, t]))
        embeddings.append(agent._emb)
        _close(actions, actions_r)
        _close(stop, stop_r)
        _close(state[0], hh)
        _close(state[1], lh)
    assert all(e is embeddings[0] for e in embeddings)  # BERT ran once
    _close(embeddings[0], emb)


@pytest.mark.parametrize("dtype,inside", [("float32", False), ("bfloat16", True)])
def test_agent_scopes_tf32(monkeypatch, dtype, inside):
    """A float32 agent's window and tick run the policies with cuDNN's and
    the matmuls' TF32 off, and both flags are restored after the call; a
    bfloat16 agent leaves them alone.  The flags are read inside the high
    level's state encoder."""
    _, port_mc = tiny_configs()
    agent = build_hcm_agent(port_mc, device="cpu", compute_dtype=dtype)
    seen = []
    forward = agent.high.state_encoder.forward

    def recording(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(agent.high.state_encoder, "forward", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    obs, masks = make_inputs(np.random.default_rng(5))
    obs, masks = _to_torch(obs), torch.from_numpy(masks)
    agent.forward_window(obs, masks, None, *agent.initial_state(B))
    tick = {"rgb": obs["rgb"][:, 0], "depth": obs["depth"][:, 0],
            "instruction": obs["instruction"]}
    agent.act(tick, agent.initial_state(B), None, masks[:, 0])
    assert seen == [(inside, inside)] * 2
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_build_hcm_agent_defaults_to_cuda():
    """Without device= the agent goes to the card; with no card it raises
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, port_mc = tiny_configs()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_hcm_agent(port_mc)
