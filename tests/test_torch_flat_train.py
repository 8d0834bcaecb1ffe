"""The flat family's train and val steps (training/steps.make_flat_train_step,
make_flat_val_step) against robo_vln_tpu/training/steps.py's, on the CPU.

Both sides get the tiny CMA and Seq2Seq of tests/test_torch_flat_models.py
with the same numpy variables and the same numpy batches: B=3, T=4, an
episode padded out in the first window, padding at the end of an episode in
the later ones, exact zero velocity targets (the progress monitor's mask),
stop targets of -1, instructions with pads.  The JAX step is built as its
trainer builds it: Adam (no decay) over the trainable leaves, a one-device
mesh, the policy bound to its BatchNorm statistics, no donation; lr 1e-4.

Tolerances are tests/test_torch_train_step.py's: losses and the hidden
state within 1e-4; each gradient within 1e-4 of ``jax.grad`` of the JAX
step's losses; Adam's moments within 1e-6 + 1e-3 relative (first) and
1e-12 + 1e-3 relative (second); parameters within 0.01·lr where the JAX
gradient stayed above 1e-6, exactly where it stayed exactly 0 (the input
columns of dead trunk channels: most of rgb_linear and rgb_kv), and within
2·lr a step elsewhere; the frozen
trunks bitwise unchanged; the heads the flax policies never create
(``progress_monitor`` without the monitor, ``sub_goal_linear``) without a
gradient or state and unchanged.  The GloVe table trains, as JAX's Adam
trains ``instruction_encoder/embedding``, though its reference key
``embedding_layer`` is a frozen module name.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.parallel import mesh as mesh_lib
from robo_vln_tpu.training import optimizers as jax_opt
from robo_vln_tpu.training import steps as jax_steps
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
from robo_vln_tpu_torch.training import optimizers, steps
from robo_vln_tpu_torch.utils.weight_port import flat_state_dict
from tests.test_torch_flat_models import (B, CMA_CASES, SEQ2SEQ_CASES, SIMPLE_PX,
                                          T, flat_inputs, jax_flat, port_flat)
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train_step import _adam_moments, _Bound, _close, _extras, _port_names

LR = 1e-4
TOL = 1e-4
GRAD_FLOOR = 1e-6
ALPHA = 0.7  # the progress monitor's weight
# CMA at 64 px: 2 x 2 trunk maps, so that the attention keys differ between
# tokens and most of rgb_kv and depth_kv get a gradient (at 32 px every rgb
# token shares its trunk channels and the depth map is one token)
CMA_PX = 64
CASES = {"cma_bi": (CMA_PX, CMA_CASES["bi"]),
         "seq2seq_pm": (SIMPLE_PX, SEQ2SEQ_CASES["simple_cnn_pm_prev"])}


def make_flat_batch(rng, px, window):
    obs, masks, prev = flat_inputs(rng, px)
    corrected = rng.random((B, T, 2)).astype(np.float32)
    corrected[0, 1, 1] = 0.0  # an exact zero target on a real step
    corrected[1, 2, 0] = 0.0  # outside the progress monitor's mask
    stop = (rng.random((B, T, 1)) > 0.7).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    pad = (slice(2, 3), slice(None)) if window == 0 else (slice(1, 2), slice(T - 2, None))
    valid[pad], corrected[pad], stop[pad] = 0.0, 0.0, -1.0
    return {**obs, "progress": rng.random((B, T)).astype(np.float32),
            "prev_actions": prev, "corrected_actions": corrected, "oracle_stop": stop,
            "not_done_masks": masks, "valid_mask": valid}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_programs(case):
    """(step, grads, tx, bound policy) of the JAX package for a case."""
    px, overrides = CASES[case]
    jax_mc, _, policy, variables, _ = jax_flat(px, overrides)
    bound = _Bound(policy, _extras(variables))
    pm = jax_mc.PROGRESS_MONITOR.use
    tx = jax_opt.masked(jax_opt.adam(), variables["params"])
    mesh = mesh_lib.make_mesh([1, 1], ["data", "model"], jax.devices()[:1])
    step = jax_steps.make_flat_train_step(bound, tx, mesh, use_progress=pm,
                                          progress_alpha=ALPHA, donate=False)

    @jax.jit
    def grads(params, batch, hidden):
        def total(p):
            a, s, x, _ = jax_steps._flat_losses(bound, p, batch, hidden,
                                                progress_alpha=ALPHA, use_progress=pm)
            return a + s + x

        return jax.grad(total)(params)

    return step, grads, tx, bound


def port_setup(case, remat=False):
    px, overrides = CASES[case]
    policy = port_flat(px, overrides)
    pm = policy.model_config.PROGRESS_MONITOR.use
    state = steps.TrainState(optimizers.adam(policy), 0)
    step = steps.make_flat_train_step(policy, use_progress=pm, progress_alpha=ALPHA,
                                      remat=remat)
    return policy, state, step


def _check_flat_train_step(case, windows):
    """The port's step against the JAX step over ``windows`` windows; the
    names of the parameters whose gradient was held to JAX's."""
    px, overrides = CASES[case]
    _, _, jpolicy, variables, _ = jax_flat(px, overrides)
    jstep, jgrads, tx, _ = jax_programs(case)
    params = variables["params"]
    jstate = jax_steps.TrainState(params, tx.init(params), jnp.asarray(0))
    policy, state, step = port_setup(case)
    names = {id(p): n for n, p in policy.named_parameters()}
    mask = optimizers.trainable_mask(policy)
    frozen = {n: p.detach().clone() for n, p in policy.named_parameters() if not mask[n]}
    table = "instruction_encoder.embedding_layer.weight"
    assert mask[table] and table not in frozen
    assert any(n.startswith("rgb_encoder.cnn.") for n in frozen) == (case == "cma_bi")
    before = {n: p.detach().clone() for n, p in policy.named_parameters()}
    checked, steady, zero = set(), {}, {}
    jh = jpolicy.initial_hidden(B)
    hidden = policy.initial_hidden(B)
    rng = np.random.default_rng(7)
    for window in range(windows):
        batch = make_flat_batch(rng, px, window)
        jbatch = jax.tree.map(jnp.asarray, batch)
        want_grads = jgrads(jstate.params, jbatch, jh)
        jstate, jh, want = jstep(jstate, jh, jbatch, LR)
        state, hidden, got = step(state, hidden, _torch(batch), LR)
        assert state.step == window + 1
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], TOL, what=key)
        _close(hidden, jh, TOL, what="hidden")
        assert not hidden.requires_grad
        if case == "seq2seq_pm":
            assert float(got["aux_loss"]) > 0

        ref_grads = _port_names(want_grads, variables, flat_state_dict)
        ref_params = _port_names(jstate.params, variables, flat_state_dict)
        moments = _adam_moments(jstate.opt_state)
        ref_mu = _port_names(moments.mu, variables, flat_state_dict)
        ref_nu = _port_names(moments.nu, variables, flat_state_dict)
        opt = state.optimizer
        for p in (p for g in opt.param_groups for p in g["params"]):
            name = names[id(p)]
            if name not in ref_grads:  # never created by the flax policy
                assert name.startswith(("progress_monitor.", "sub_goal_linear.")), name
                assert p.grad is None and p not in opt.state, name
                assert torch.equal(p, before[name]), name
                continue
            _close(p.grad, ref_grads[name], TOL, what=f"grad {name}")
            checked.add(name)
            g = np.abs(np.asarray(ref_grads[name]))
            steady[name] = (g > GRAD_FLOOR) & steady.get(name, True)
            zero[name] = (g == 0) & zero.get(name, True)
            err = np.abs(p.detach().numpy() - ref_params[name])
            assert err.max() <= 2 * LR * (window + 1), name
            assert (err[steady[name]] <= 0.01 * LR).all(), name
            assert (err[zero[name]] == 0).all(), name
            st = opt.state[p]
            _close(st["exp_avg"], ref_mu[name], 1e-6, 1e-3, what=f"mu {name}")
            _close(st["exp_avg_sq"], ref_nu[name], 1e-12, 1e-3, what=f"nu {name}")
    for name, value in frozen.items():
        assert torch.equal(policy.get_parameter(name), value), name
        assert policy.get_parameter(name).grad is None
    assert table in checked and not torch.equal(policy.get_parameter(table), before[table])
    tight = sum((steady[n] | zero[n]).sum() for n in steady)
    assert tight > 0.5 * sum(s.size for s in steady.values())
    return checked


@pytest.mark.parametrize("case,windows", [("cma_bi", 2), ("seq2seq_pm", 1)])
def test_flat_train_step_matches_jax(case, windows):
    _check_flat_train_step(case, windows)


def test_flat_train_step_through_fused_lstm_matches_jax(monkeypatch):
    """CMA's two state encoders through ops/fused_lstm._FusedLSTM, the
    Function that launches the kernels on the card, its launches stood in
    for by their plain versions: the same checks, and each encoder's
    weight_hh_l0 receives JAX's gradient."""
    calls = []

    def forward(*args):
        calls.append("forward")
        return lstm_recurrence(*args)

    def backward(*args, masks_grad=True):
        calls.append(("backward", masks_grad))
        return lstm_recurrence_backward(*args, masks_grad=masks_grad)

    def through_function(gates_x, masks, h0, c0, w_hh):
        f32 = [t.float().contiguous() for t in (gates_x, masks, h0, c0)]
        return fused_lstm._FusedLSTM.apply(*f32, w_hh.float())

    monkeypatch.setattr(fused_lstm, "lstm_seq_cuda", forward)
    monkeypatch.setattr(fused_lstm, "lstm_seq_backward_cuda", backward)
    monkeypatch.setattr(fused_lstm, "fused_lstm_sequence", through_function)
    checked = _check_flat_train_step("cma_bi", 1)
    assert calls == ["forward"] * 2 + [("backward", False)] * 2
    assert {"state_encoder.rnn.weight_hh_l0",
            "second_state_encoder.rnn.weight_hh_l0"} <= checked


def test_flat_val_step_matches_jax():
    px, overrides = CASES["seq2seq_pm"]
    _, _, jpolicy, variables, _ = jax_flat(px, overrides)
    _, _, _, bound = jax_programs("seq2seq_pm")
    jval = jax.jit(jax_steps.make_flat_val_step(bound, use_progress=True,
                                                progress_alpha=ALPHA))
    policy, _, _ = port_setup("seq2seq_pm")
    val = steps.make_flat_val_step(policy, use_progress=True, progress_alpha=ALPHA)
    jh, hidden = jpolicy.initial_hidden(B), policy.initial_hidden(B)
    rng = np.random.default_rng(9)
    for window in range(2):
        batch = make_flat_batch(rng, px, window)
        jh, want = jval(variables["params"], jh, jax.tree.map(jnp.asarray, batch))
        hidden, got = val(hidden, _torch(batch))
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], TOL, what=key)
        _close(hidden, jh, TOL, what="hidden")
    assert not policy.training


def test_flat_nonfinite_loss_skips_the_update():
    """A non-finite loss leaves the parameters and Adam's state as they
    were and keeps no gradient; the step counter still advances."""
    policy, state, step = port_setup("seq2seq_pm")
    rng = np.random.default_rng(3)
    hidden = policy.initial_hidden(B)
    state, hidden, _ = step(state, hidden, _torch(make_flat_batch(rng, SIMPLE_PX, 0)), LR)
    params = {n: p.detach().clone() for n, p in policy.named_parameters()}
    moments = {id(p): {k: v.clone() for k, v in st.items()}
               for p, st in state.optimizer.state.items()}
    bad = make_flat_batch(rng, SIMPLE_PX, 1)
    bad["corrected_actions"][0, 0, 0] = np.nan
    state, _, metrics = step(state, hidden, _torch(bad), LR)
    assert state.step == 2 and float(metrics["skipped_nonfinite"]) == 1.0
    assert not torch.isfinite(metrics["total_loss"])
    for n, p in policy.named_parameters():
        assert torch.equal(p, params[n]) and p.grad is None, n
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            assert torch.equal(v, moments[id(p)][k]), k


def test_flat_remat_gives_the_same_grads():
    """TPU.REMAT recomputes the losses' forward in the backward
    (torch.utils.checkpoint): the same gradients."""
    batch = _torch(make_flat_batch(np.random.default_rng(4), CMA_PX, 0))
    grads = []
    for remat in (False, True):
        policy, state, step = port_setup("cma_bi", remat=remat)
        step(state, policy.initial_hidden(B), batch, LR)
        grads.append({n: p.grad.clone() for n, p in policy.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 10
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, atol=1e-6, rtol=0, msg=name)
