"""The port's hierarchical train and val steps (training/steps.py) against
robo_vln_tpu/training/steps.make_hier_train_step and make_hier_val_step.

Both sides get the tiny HCM of tests/test_torch_agent.py (one ResNet block a
stage, synced frozen trunks, shared trunk pass) with the same numpy
variables and the same numpy batches: B=3, T=4, an episode padded out in the
first window (the B / real_B rescaling of the velocity MSE), padding at the
end of an episode in the later ones, an exact zero velocity target, ignored
oracle steps and stop targets of -1.  Dropout is off on both sides
(VISUAL_LING_ATTN.dropout = 0): the port cannot draw JAX's "rbg" bits.  AdamW
(high) and Adam (low) both take weight decay 1e-3 (MODEL.TRANSFORMER.
weight_decay, as the JAX trainer sets them), lr 1e-4.  The JAX step is built
as bench.py builds it: a one-device mesh, the policies bound to their
BatchNorm statistics, no donation.

Tolerances, float32 on both sides:
* losses, accuracy and both hidden states within 1e-4 absolute (the
  forward's tolerance of test_torch_agent.py);
* the step's gradients within 1e-4 absolute, against ``jax.grad`` of the
  same losses function the JAX step differentiates;
* Adam's first moments within 1e-6 + 1e-3 relative and second moments
  within 1e-12 + 1e-3 relative: they are running means of g and g², so they
  inherit the gradients' agreement (about 1e-7 here);
* parameters, in units of lr: within 0.01·lr wherever the JAX gradient's
  magnitude stayed above 1e-6 at every step (most elements), and within
  2·lr a step everywhere else.  Adam's update is about lr·sign(g) whatever |g| is, so
  where a gradient is float noise around 0 (the key bias of attention,
  whose exact gradient is 0), the two sides may step in opposite directions;
* frozen parameters (the trunks and BERT) bitwise unchanged;
* the progress monitors, which the port's policies carry and the flax
  policies never create (nothing calls them): no gradient, no optimizer
  state, bitwise unchanged, as the JAX step has no such leaves to update.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robo_vln_tpu.models import build_hierarchical_policies as jax_build
from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn
from robo_vln_tpu.models import sync_frozen_trunks as jax_sync
from robo_vln_tpu.parallel import mesh as mesh_lib
from robo_vln_tpu.training import optimizers as jax_opt
from robo_vln_tpu.training import steps as jax_steps
from robo_vln_tpu_torch.models import (
    build_hierarchical_policies,
    frozen_trunks_identical,
    init_weights,
    make_shared_trunk_fn,
    sync_frozen_trunks,
)
from robo_vln_tpu_torch.models.transformer import VisualLingAttn, dropout
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.ops.rnn import lstm_recurrence, lstm_recurrence_backward
from robo_vln_tpu_torch.training import optimizers, steps
from robo_vln_tpu_torch.utils.weight_port import (
    high_level_state_dict,
    load_hierarchical_weights,
    low_level_state_dict,
)
from tests.test_torch_agent import make_inputs, random_variables, tiny_configs
from tests.test_torch_threads import one_torch_thread  # noqa: F401

B, T = 3, 4
LR = 1e-4
WD = 1e-3
TOL = 1e-4
GRAD_FLOOR = 1e-6  # |g| above which Adam's step direction is not noise


@functools.lru_cache(maxsize=None)
def jax_setup():
    """(jax_mc, high, low, high_vars, low_vars) at dropout 0, synced trunks."""
    jax_mc, _ = tiny_configs()
    jax_mc.VISUAL_LING_ATTN.dropout = 0.0
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
    return jax_mc, high, low, high_vars, low_vars


class _Bound:
    """A policy bound to its non-param variables (bench.py's ``_B``)."""

    def __init__(self, policy, extra):
        self._p, self._e = policy, extra

    def apply(self, variables, *args, **kwargs):
        return self._p.apply({**self._e, **variables}, *args, **kwargs)


def _extras(variables):
    return {k: v for k, v in variables.items() if k != "params"}


@functools.lru_cache(maxsize=None)
def jax_programs(deviations: bool):
    """(train step, grads function, tx_high, tx_low) of the JAX package,
    compiled once per configuration.  ``deviations``: VALID_MASK_VELOCITY_MSE
    and APPLY_INFLECTION_WEIGHTS both on."""
    jax_mc, high, low, high_vars, low_vars = jax_setup()
    hx, lx = _extras(high_vars), _extras(low_vars)
    trunk_fn = jax_trunk_fn(jax_mc, jnp.float32, hx)
    hb, lb = _Bound(high, hx), _Bound(low, lx)
    iw = jax_mc.inflection_weight_coef if deviations else None
    tx_h = jax_opt.masked(jax_opt.adamw(WD), high_vars["params"])
    tx_l = jax_opt.masked(jax_opt.adam(WD), low_vars["params"])
    mesh = mesh_lib.make_mesh([1, 1], ["data", "model"], jax.devices()[:1])
    step = jax_steps.make_hier_train_step(
        hb, lb, tx_h, tx_l, mesh, donate=False, trunk_fn=trunk_fn,
        inflection_coef=iw, valid_velocity_mse=deviations)

    @jax.jit
    def grads(hp, lp, batch, hh, lh):
        def total(both):
            out = jax_steps._hier_losses(hb, lb, both[0], both[1], batch, hh, lh,
                                         trunk_fn=trunk_fn, inflection_coef=iw,
                                         valid_velocity_mse=deviations)
            return out[0] + out[1] + out[2]

        return jax.grad(total)((hp, lp))

    return step, grads, tx_h, tx_l


def make_batch(rng, window):
    obs, masks = make_inputs(rng, B, T)
    oracle = rng.integers(0, 5, (B, T)).astype(np.float32)
    corrected = rng.random((B, T, 2)).astype(np.float32)
    corrected[0, 1, 1] = 0.0  # an exact zero target on a real step
    stop = (rng.random((B, T, 1)) > 0.7).astype(np.float32)
    valid = np.ones((B, T), np.float32)
    pad = (slice(2, 3), slice(None)) if window == 0 else (slice(1, 2), slice(T - 2, None))
    valid[pad], oracle[pad], corrected[pad], stop[pad] = 0.0, 0.0, 0.0, -1.0
    return {**obs, "vln_oracle_action_sensor": oracle,
            "prev_actions": rng.standard_normal((B, T, 2)).astype(np.float32),
            "corrected_actions": corrected, "oracle_stop": stop,
            "not_done_masks": masks, "valid_mask": valid}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def port_setup(deviations=False, remat=False, bert_trainable=False, dropout_rate=0.0,
               weights=True):
    """(high, low, state, step_fn, trunk_fn): the port's float32 policies with
    the JAX variables (or random weights from seed 0 with synced trunks)."""
    _, port_mc = tiny_configs()
    port_mc.VISUAL_LING_ATTN.dropout = dropout_rate
    port_mc.BERT.trainable = bert_trainable
    high, low = build_hierarchical_policies(port_mc, compute_dtype=torch.float32)
    if weights:
        _, _, _, high_vars, low_vars = jax_setup()
        load_hierarchical_weights(high, low, high_vars, low_vars)
    else:
        sync_frozen_trunks(high, low)
    assert frozen_trunks_identical(high, low)
    trunk_fn = make_shared_trunk_fn(high)
    unfrozen = ("embedding_layer",) if bert_trainable else ()
    state = steps.HierTrainState(
        steps.TrainState(optimizers.adamw(high, WD, unfrozen), 0),
        steps.TrainState(optimizers.adam(low, WD, unfrozen), 0))
    step = steps.make_hier_train_step(
        high, low, trunk_fn=trunk_fn, remat=remat,
        inflection_coef=port_mc.inflection_weight_coef if deviations else None,
        valid_velocity_mse=deviations)
    return high, low, state, step, trunk_fn


def _port_names(tree, variables, to_state_dict):
    """A JAX tree shaped like params (grads, a moment) under the port's
    parameter names; MaskedNode leaves (frozen, no moment) become zeros."""
    full = jax.tree.map(
        lambda x, p: np.zeros_like(p) if isinstance(x, optax.MaskedNode) else np.asarray(x),
        tree, variables["params"], is_leaf=lambda x: isinstance(x, optax.MaskedNode))
    return to_state_dict({**_extras(variables), "params": full})


def _adam_moments(opt_state):
    found = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _close(got, want, atol, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("windows,deviations", [(1, False), (3, False), (1, True)])
def test_train_step_matches_jax(windows, deviations):
    _check_train_step(windows, deviations)


def test_train_step_through_fused_lstm_matches_jax(monkeypatch):
    """One window with both LSTMs through ops/fused_lstm._FusedLSTM, the
    Function that wraps the kernels on the card, its forward and backward
    launches stood in for by their plain versions (lstm_recurrence,
    lstm_recurrence_backward): the same checks as the plain step, at the
    same tolerances.  Among them, each level's weight_hh_l0 receives JAX's
    gradient through the transposed view ``weight_hh_l0.t()`` that the
    state encoder passes."""
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
    checked = _check_train_step(1, False)
    assert calls == ["forward"] * 2 + [("backward", False)] * 2
    assert {("high", "state_encoder.rnn.weight_hh_l0"),
            ("low", "state_encoder.rnn.weight_hh_l0")} <= checked


def _check_train_step(windows, deviations):
    """The port's step against the JAX step over ``windows`` windows; the
    (level, name) of every parameter whose gradient was held to JAX's."""
    checked = set()
    _, jhigh, jlow, high_vars, low_vars = jax_setup()
    jstep, jgrads, tx_h, tx_l = jax_programs(deviations)
    hp, lp = high_vars["params"], low_vars["params"]
    jstate = jax_steps.HierTrainState(
        jax_steps.TrainState(hp, tx_h.init(hp), jnp.asarray(0)),
        jax_steps.TrainState(lp, tx_l.init(lp), jnp.asarray(0)))
    high, low, state, step, _ = port_setup(deviations)
    policies = (("high", high, high_vars, high_level_state_dict),
                ("low", low, low_vars, low_level_state_dict))
    names = {id(p): (level, n) for level, pol, _, _ in policies
             for n, p in pol.named_parameters()}
    frozen = {(level, n): p.detach().clone() for level, pol, _, _ in policies
              for n, p in pol.named_parameters()
              if not optimizers.trainable_mask(pol)[n]}
    unused = {(level, n): p.detach().clone() for level, pol, _, _ in policies
              for n, p in pol.named_parameters() if n.startswith("progress_monitor.")}
    assert unused
    steady = {}  # (level, name) -> elements whose JAX gradient stayed above GRAD_FLOOR
    jhh, jlh = jhigh.initial_hidden(B), jlow.initial_hidden(B)
    hh, lh = high.initial_hidden(B), low.initial_hidden(B)
    rng = np.random.default_rng(7)
    for window in range(windows):
        batch = make_batch(rng, window)
        jbatch = jax.tree.map(jnp.asarray, batch)
        want_grads = jgrads(jstate.high.params, jstate.low.params, jbatch, jhh, jlh)
        jstate, jhh, jlh, want = jstep(jstate, jhh, jlh, jbatch, LR, LR)
        state, hh, lh, got = step(state, hh, lh, _torch(batch), LR, LR)

        assert (state.high.step, state.low.step) == (window + 1, window + 1)
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], TOL, what=key)
        _close(hh, jhh, TOL, what="high hidden")
        _close(lh, jlh, TOL, what="low hidden")
        assert not hh.requires_grad and not lh.requires_grad

        for (level, pol, variables, to_sd), jg, jparams, jopt, opt in zip(
                policies, want_grads, (jstate.high.params, jstate.low.params),
                (jstate.high.opt_state, jstate.low.opt_state),
                (state.high.optimizer, state.low.optimizer)):
            ref_grads = _port_names(jg, variables, to_sd)
            ref_params = _port_names(jparams, variables, to_sd)
            moments = _adam_moments(jopt)
            ref_mu = _port_names(moments.mu, variables, to_sd)
            ref_nu = _port_names(moments.nu, variables, to_sd)
            for p in (p for g in opt.param_groups for p in g["params"]):
                key = names[id(p)]
                name = key[1]
                what = f"{level} {name}"
                if name not in ref_grads:  # never created by the flax policy
                    assert name.startswith("progress_monitor."), what
                    assert p.grad is None and p not in opt.state, what
                    assert torch.equal(p, unused[key]), what
                    continue
                _close(p.grad, ref_grads[name], TOL, what=f"grad {what}")
                checked.add(key)
                big = np.abs(np.asarray(ref_grads[name])) > GRAD_FLOOR
                steady[key] = big & steady.get(key, True)
                err = np.abs(p.detach().numpy() - ref_params[name])
                assert err.max() <= 2 * LR * (window + 1), what
                assert (err[steady[key]] <= 0.01 * LR).all(), what
                st = opt.state[p]
                _close(st["exp_avg"], ref_mu[name], 1e-6, 1e-3, what=f"mu {what}")
                _close(st["exp_avg_sq"], ref_nu[name], 1e-12, 1e-3, what=f"nu {what}")
                assert int(st["step"]) == window + 1
    for (level, name), before in frozen.items():
        pol = high if level == "high" else low
        assert torch.equal(pol.get_parameter(name), before), name
        assert pol.get_parameter(name).grad is None
    assert sum(s.sum() for s in steady.values()) > 0.5 * sum(s.size for s in steady.values())
    return checked


def test_val_step_matches_jax():
    jax_mc, jhigh, jlow, high_vars, low_vars = jax_setup()
    trunk_fn = jax_trunk_fn(jax_mc, jnp.float32, _extras(high_vars))
    jval = jax_steps.make_hier_val_step(_Bound(jhigh, _extras(high_vars)),
                                        _Bound(jlow, _extras(low_vars)), trunk_fn=trunk_fn)
    high, low, _, _, port_trunk = port_setup()
    val = steps.make_hier_val_step(high, low, trunk_fn=port_trunk)
    high.train()
    batch = make_batch(np.random.default_rng(11), 1)
    jhh, jlh, want = jval(high_vars["params"], low_vars["params"], jhigh.initial_hidden(B),
                          jlow.initial_hidden(B), jax.tree.map(jnp.asarray, batch))
    hh, lh, got = val(high.initial_hidden(B), low.initial_hidden(B), _torch(batch))
    assert not high.training and not low.training
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], TOL, what=key)
        assert not got[key].requires_grad
    _close(hh, jhh, TOL)
    _close(lh, jlh, TOL)


def test_nonfinite_loss_skips_the_update():
    """A NaN in corrected_actions makes the loss NaN: neither optimizer
    steps, so parameters, Adam moments and the optimizers' step counts stay
    as they were, while the train state's step counters advance."""
    high, low, state, step, _ = port_setup()
    rng = np.random.default_rng(3)
    hh, lh = high.initial_hidden(B), low.initial_hidden(B)
    state, hh, lh, _ = step(state, hh, lh, _torch(make_batch(rng, 0)), LR, LR)
    params = {n: p.detach().clone() for pol in (high, low) for n, p in
              pol.named_parameters(prefix=("h" if pol is high else "l"))}
    opt_states = [{id(p): {k: v.clone() for k, v in opt.state[p].items()} for p in opt.state}
                  for opt in (state.high.optimizer, state.low.optimizer)]
    bad = make_batch(rng, 1)
    bad["corrected_actions"][0, 0, 0] = np.nan
    state, _, _, metrics = step(state, hh, lh, _torch(bad), LR, LR)
    assert not torch.isfinite(metrics["low_level_action_loss"])
    assert (state.high.step, state.low.step) == (2, 2)
    for pol, prefix in ((high, "h"), (low, "l")):
        for n, p in pol.named_parameters(prefix=prefix):
            assert torch.equal(p, params[n]), n
            assert p.grad is None
    for opt, before in zip((state.high.optimizer, state.low.optimizer), opt_states):
        assert before
        for p in opt.state:
            for k, v in opt.state[p].items():
                assert torch.equal(v, before[id(p)][k]), k
            assert int(opt.state[p]["step"]) == 1


@pytest.mark.parametrize("dropout_rate", [0.0, 0.25])
def test_remat_gives_the_same_grads(dropout_rate):
    """TPU.REMAT recomputes the forward in the backward; with dropout on,
    the recompute redraws the same masks (the generator is seeded inside the
    recomputed function), so the gradients equal those without remat.  The
    step counter is fixed at 5 on both."""
    def grads(remat, at_step):
        high, low, state, step, _ = port_setup(remat=remat, dropout_rate=dropout_rate,
                                               weights=False)
        state = steps.HierTrainState(state.high._replace(step=at_step),
                                     state.low._replace(step=at_step))
        batch = _torch(make_batch(np.random.default_rng(9), 1))
        step(state, high.initial_hidden(B), low.initial_hidden(B), batch, LR, LR)
        return {n: p.grad for pol, pre in ((high, "h"), (low, "l"))
                for n, p in pol.named_parameters(prefix=pre) if p.grad is not None}

    plain, remat = grads(False, 5), grads(True, 5)
    assert plain.keys() == remat.keys() and plain
    for name, g in plain.items():
        torch.testing.assert_close(remat[name], g, atol=1e-6, rtol=0, msg=name)
    if dropout_rate:  # the masks are live: another step draws others
        other = grads(False, 6)
        assert max((other[n] - g).abs().max() for n, g in plain.items()) > 1e-4


def test_dropout_masks_by_step():
    """The same seed and step draw the same masks, another step others; in
    eval mode, or without a generator, the block computes bitwise what it
    computes at rate 0."""
    torch.manual_seed(0)
    attn = VisualLingAttn(16, 2, 32, 1, 16, 32, dropout=0.25)
    init_weights(attn, torch.Generator().manual_seed(1))
    ins, vis = torch.randn(4, 6, 32), torch.randn(4, 5, 16)
    attn.train()
    a = attn(ins, vis, generator=steps.dropout_generator(3, "cpu"))
    b = attn(ins, vis, generator=steps.dropout_generator(3, "cpu"))
    c = attn(ins, vis, generator=steps.dropout_generator(4, "cpu"))
    no_gen = attn(ins, vis)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert (a - c).abs().max() > 1e-3
    assert (a - no_gen).abs().max() > 1e-3
    attn.eval()
    evaluated = attn(ins, vis, generator=steps.dropout_generator(3, "cpu"))
    attn.dropout = 0.0
    for layer in attn.layers:
        layer.enc_att.dropout = layer.pwff.dropout = 0.0
    attn.train()
    rate0 = attn(ins, vis, generator=steps.dropout_generator(3, "cpu"))
    torch.testing.assert_close(evaluated, no_gen, atol=0, rtol=0)
    torch.testing.assert_close(evaluated, rate0, atol=0, rtol=0)


def test_dropout_rate():
    """About a quarter of a large tensor is zeroed at rate 0.25 and the rest
    scaled by 1 / 0.75; outside training, the identity."""
    x = torch.ones(1_000_000)
    y = dropout(x, 0.25, steps.dropout_generator(0, "cpu"), training=True)
    zeroed = (y == 0).float().mean().item()
    assert abs(zeroed - 0.25) < 0.005
    torch.testing.assert_close(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    assert dropout(x, 0.25, steps.dropout_generator(0, "cpu"), training=False) is x
    assert dropout(x, 0.25, None, training=True) is x


@pytest.mark.parametrize("trainable", [False, True])
def test_bert_trainable(trainable):
    """MODEL.BERT.trainable=False leaves BERT bitwise untouched and out of
    the optimizer; True trains it with the policy."""
    high, low, state, step, _ = port_setup(bert_trainable=trainable, weights=False)
    bert = {n: p.detach().clone() for n, p in high.embedding_layer.named_parameters()}
    in_opt = {id(p) for g in state.high.optimizer.param_groups for p in g["params"]}
    assert all((id(p) in in_opt) == trainable for p in high.embedding_layer.parameters())
    state, *_ = step(state, high.initial_hidden(B), low.initial_hidden(B),
                     _torch(make_batch(np.random.default_rng(2), 1)), LR, LR)
    moved = [n for n, p in high.embedding_layer.named_parameters()
             if not torch.equal(p, bert[n])]
    if trainable:
        assert len(moved) > len(bert) // 2
    else:
        assert moved == []


@pytest.mark.parametrize("dtype,inside", [(torch.float32, False), (torch.bfloat16, True)])
def test_train_step_scopes_tf32(monkeypatch, dtype, inside):
    """A float32 train step runs its policies with cuDNN's and the matmuls'
    TF32 off and restores both flags after; bfloat16 leaves them alone."""
    _, port_mc = tiny_configs()
    high, low = build_hierarchical_policies(port_mc, compute_dtype=dtype)
    sync_frozen_trunks(high, low)
    state = steps.HierTrainState(steps.TrainState(optimizers.adamw(high, WD), 0),
                                 steps.TrainState(optimizers.adam(low, WD), 0))
    step = steps.make_hier_train_step(high, low, trunk_fn=make_shared_trunk_fn(high))
    seen = []
    forward = high.state_encoder.forward

    def recording(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(*args, **kwargs)

    monkeypatch.setattr(high.state_encoder, "forward", recording)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    step(state, high.initial_hidden(B), low.initial_hidden(B),
         _torch(make_batch(np.random.default_rng(4), 1)), LR, LR)
    assert seen == [(inside, inside)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("apply,use_iw,coef", [(False, True, None), (True, False, None),
                                               (True, True, 3.2)])
def test_inflection_coef_needs_both_keys(apply, use_iw, coef):
    """The high-level CE is inflection-weighted only with both
    TPU.APPLY_INFLECTION_WEIGHTS and DAGGER.USE_IW, as the JAX trainer
    decides (hierarchical_trainer.py:140-144)."""
    from robo_vln_tpu_torch.config import get_config

    cfg = get_config(opts=["TPU.APPLY_INFLECTION_WEIGHTS", apply, "DAGGER.USE_IW", use_iw])
    assert steps.inflection_coef_from(cfg) == coef
