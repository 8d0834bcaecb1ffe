"""The HCM at two settings a user can make that reach the shapes past the
kernels' former ranges, against the JAX package: ``STATE_ENCODER.hidden_size``
30 (both LSTMs, off a multiple of 4: the kernels' wrappers pad it to 32) and
``VISUAL_LING_ATTN.h`` 1 (one head of the whole d_model).

The tiny HCM of tests/test_torch_agent.py with those two keys changed on
both sides and the same numpy variables.  The LSTM runs through
ops/fused_lstm._FusedLSTM, the Function that wraps the kernels on the card,
its launches stood in for by the padded forms the wrappers take at H = 30
(fused_lstm.padded_forward and padded_backward around the plain versions):
the card's path but for the kernels.  Tolerances, float32 on both sides, as
tests/test_torch_agent.py and tests/test_torch_train_step.py hold them: the
window's outputs and hidden states within 1e-4; one train step's losses,
hidden states and every trainable leaf's gradient within 1e-4, against
``jax.grad`` of the losses the JAX step differentiates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.models import build_hierarchical_policies as jax_build
from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn
from robo_vln_tpu.models import sync_frozen_trunks as jax_sync
from robo_vln_tpu.training import steps as jax_steps
from robo_vln_tpu_torch import build_hcm_agent
from robo_vln_tpu_torch.models import build_hierarchical_policies, make_shared_trunk_fn
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
from robo_vln_tpu_torch.training import optimizers, steps
from robo_vln_tpu_torch.utils.weight_port import (
    high_level_state_dict,
    load_hierarchical_weights,
    low_level_state_dict,
)
from tests.test_torch_agent import _set, make_inputs, random_variables, tiny_configs
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import _Bound, _extras, _port_names, _torch, make_batch

TOL = 1e-4
H = 30
OVERRIDES = {"STATE_ENCODER.hidden_size": H, "VISUAL_LING_ATTN.h": 1,
             "VISUAL_LING_ATTN.dropout": 0.0}
B, T = 3, 4  # make_batch's


@functools.lru_cache(maxsize=None)
def setup():
    """(jax_mc, port_mc, high, low, high_vars, low_vars): both configs at
    the tiny sizes with OVERRIDES, the JAX variables drawn from numpy seeds,
    the low level's frozen trunks synced to the high level's."""
    jax_mc, port_mc = (_set(mc, OVERRIDES) for mc in tiny_configs())
    jax_mc.freeze()
    high, low = jax_build(jax_mc)
    obs, masks = make_inputs(np.random.default_rng(0), B, T)
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


@pytest.fixture
def padded_lstm(monkeypatch):
    """The LSTM through _FusedLSTM, its launches the padded plain forms;
    records the hidden size each launch saw."""
    seen = []

    def forward(*args):
        return fused_lstm.padded_forward(
            lambda *a: seen.append(a[2].shape[-1]) or lstm_recurrence(*a), *args)

    def backward(*args, masks_grad=True):
        return fused_lstm.padded_backward(
            lambda *a, masks_grad: seen.append(a[2].shape[-1]) or lstm_recurrence_backward(
                *a, masks_grad=masks_grad), *args, masks_grad=masks_grad)

    def through_function(gates_x, masks, h0, c0, w_hh):
        f32 = [t.float().contiguous() for t in (gates_x, masks, h0, c0)]
        return fused_lstm._FusedLSTM.apply(*f32, w_hh.float())

    monkeypatch.setattr(fused_lstm, "lstm_seq_cuda", forward)
    monkeypatch.setattr(fused_lstm, "lstm_seq_backward_cuda", backward)
    monkeypatch.setattr(fused_lstm, "fused_lstm_sequence", through_function)
    return seen


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=TOL, err_msg=what)


def test_window_matches_jax(padded_lstm):
    """The serving window (shared trunks, high level, argmax, low level) at
    hidden size 30 and one attention head."""
    jax_mc, port_mc, high, low, high_vars, low_vars = setup()
    agent = build_hcm_agent(port_mc, device="cpu", compute_dtype="float32",
                            weights=(high_vars, low_vars))
    assert agent.high.state_encoder.rnn.weight_hh_l0.shape == (4 * H, H)
    obs, masks = make_inputs(np.random.default_rng(3), B, T)
    trunk_fn = jax_trunk_fn(jax_mc, jnp.float32, {"batch_stats": high_vars["batch_stats"]})
    jobs = jax.tree.map(jnp.asarray, obs)
    jobs = {**jobs, **trunk_fn(high_vars["params"], jobs)}
    logits, hh = high.apply(high_vars, jobs, high.initial_hidden(B), None, jnp.asarray(masks))
    actions, stop, lh = low.apply(low_vars, jobs, low.initial_hidden(B), None,
                                  jnp.asarray(masks), jnp.argmax(logits, -1))
    got = agent.forward_window({k: torch.from_numpy(v) for k, v in obs.items()},
                               torch.from_numpy(masks), None, *agent.initial_state(B))
    assert padded_lstm == [fused_lstm.padded_hidden(H)] * 2  # both levels, padded to 32
    for g, r, what in zip(got, (actions, stop, logits, hh, lh),
                          ("actions", "stop", "logits", "high hidden", "low hidden")):
        _close(g, r, what)


def test_train_step_matches_jax(padded_lstm):
    """One hierarchical train step: losses, hidden states and every
    trainable leaf's gradient against jax.grad of the JAX step's losses."""
    jax_mc, port_mc, jhigh, jlow, high_vars, low_vars = setup()
    hx, lx = _extras(high_vars), _extras(low_vars)
    trunk_fn = jax_trunk_fn(jax_mc, jnp.float32, hx)
    hb, lb = _Bound(jhigh, hx), _Bound(jlow, lx)
    batch = make_batch(np.random.default_rng(7), 0)

    def total(both, jbatch):
        out = jax_steps._hier_losses(hb, lb, both[0], both[1], jbatch, jhigh.initial_hidden(B),
                                     jlow.initial_hidden(B), trunk_fn=trunk_fn)
        return out[0] + out[1] + out[2], out[:5]

    (_, want), want_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(
        (high_vars["params"], low_vars["params"]), jax.tree.map(jnp.asarray, batch))

    high, low = build_hierarchical_policies(port_mc, compute_dtype=torch.float32)
    load_hierarchical_weights(high, low, high_vars, low_vars)
    state = steps.HierTrainState(steps.TrainState(optimizers.adamw(high, 1e-3), 0),
                                 steps.TrainState(optimizers.adam(low, 1e-3), 0))
    step = steps.make_hier_train_step(high, low, trunk_fn=make_shared_trunk_fn(high))
    _, hh, lh, got = step(state, high.initial_hidden(B), low.initial_hidden(B),
                          _torch(batch), 1e-4, 1e-4)
    assert padded_lstm == [fused_lstm.padded_hidden(H)] * 4  # forward and backward, both levels
    for key, w in zip(("high_level_loss", "low_level_action_loss", "low_level_stop_loss"), want):
        _close(got[key], w, key)
    _close(hh, want[3], "high hidden")
    _close(lh, want[4], "low hidden")
    checked = 0
    for pol, variables, jg, to_sd in ((high, high_vars, want_grads[0], high_level_state_dict),
                                      (low, low_vars, want_grads[1], low_level_state_dict)):
        ref = _port_names(jg, variables, to_sd)
        for name, p in pol.named_parameters():
            if optimizers.trainable_mask(pol)[name] and name in ref:
                _close(p.grad, ref[name], f"grad {name}")
                checked += 1
    names = {n for n, _ in high.named_parameters()}
    assert {"state_encoder.rnn.weight_hh_l0", "state_encoder.rnn.weight_ih_l0"} <= names
    assert checked > 20
