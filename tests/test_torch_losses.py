"""The port's losses (ops/losses.py) and the host-side pieces of its
optimizers (training/optimizers.py) against the JAX package.

Each loss gets the same numpy inputs on both sides, with padding and
ignored rows, and the cases where every row is padding or ignored; values
and gradients must agree within 1e-6 (float32, the same arithmetic in
another summation order).  The cyclic LR schedule must equal JAX's, and the
trainable mask must freeze the same names."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from robo_vln_tpu.ops import losses as jax_losses
from robo_vln_tpu.training import optimizers as jax_opt
from robo_vln_tpu_torch.ops import losses
from robo_vln_tpu_torch.training import optimizers
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-6


def _velocity(rng, n=24, pad_from=16):
    pred = rng.standard_normal((n, 2)).astype(np.float32)
    target = rng.standard_normal((n, 2)).astype(np.float32)
    target[pad_from:] = 0.0  # padded steps
    target[3, 1] = 0.0  # an exact zero on a real step, masked too (the quirk)
    valid = np.zeros(n, np.float32)
    valid[:pad_from] = 1.0
    return pred, target, valid


def _stop(rng, n=30, pad_from=22):
    logits = (3 * rng.standard_normal((n, 1))).astype(np.float32)
    target = (rng.random((n, 1)) > 0.7).astype(np.float32)
    target[pad_from:] = -1.0
    return logits, target


def _subgoal(rng, n=40, ignore_all=False):
    logits = rng.standard_normal((n, 4)).astype(np.float32)
    oracle = rng.integers(0, 5, size=(n,)).astype(np.float32)  # 0 = ignore
    if ignore_all:
        oracle[:] = 0.0
    weights = (rng.random(n) + 0.5).astype(np.float32)
    return logits, oracle, weights


def _progress(rng, n=25, mask_none=False):
    ph = np.tanh(rng.standard_normal(n)).astype(np.float32)
    pr = rng.random(n).astype(np.float32)
    mask = np.zeros(n, bool) if mask_none else rng.random(n) > 0.3
    return ph, pr, mask


# (name, inputs from rng, index of the differentiated input, port fn, JAX fn)
CASES = {
    "velocity_mse": (lambda r: _velocity(r)[:2], 0,
                     losses.masked_velocity_mse, jax_losses.masked_velocity_mse),
    "velocity_mse_all_padding": (lambda r: _velocity(r, pad_from=0)[:2], 0,
                                 losses.masked_velocity_mse, jax_losses.masked_velocity_mse),
    "validmask_mse": (_velocity, 0,
                      losses.validmask_velocity_mse, jax_losses.validmask_velocity_mse),
    "validmask_mse_all_padding": (lambda r: _velocity(r, pad_from=0), 0,
                                  losses.validmask_velocity_mse,
                                  jax_losses.validmask_velocity_mse),
    "stop_bce": (_stop, 0, losses.masked_stop_bce, jax_losses.masked_stop_bce),
    "stop_bce_all_padding": (lambda r: _stop(r, pad_from=0), 0,
                             losses.masked_stop_bce, jax_losses.masked_stop_bce),
    "subgoal_ce": (lambda r: _subgoal(r)[:2], 0,
                   losses.subgoal_cross_entropy, jax_losses.subgoal_cross_entropy),
    "subgoal_ce_weighted": (_subgoal, 0,
                            losses.subgoal_cross_entropy, jax_losses.subgoal_cross_entropy),
    "subgoal_ce_all_ignored": (lambda r: _subgoal(r, ignore_all=True)[:2], 0,
                               losses.subgoal_cross_entropy, jax_losses.subgoal_cross_entropy),
    "subgoal_ce_weighted_all_ignored": (lambda r: _subgoal(r, ignore_all=True), 0,
                                        losses.subgoal_cross_entropy,
                                        jax_losses.subgoal_cross_entropy),
    "progress_mse": (_progress, 0, losses.progress_monitor_mse, jax_losses.progress_monitor_mse),
    "progress_mse_none_valid": (lambda r: _progress(r, mask_none=True), 0,
                                losses.progress_monitor_mse, jax_losses.progress_monitor_mse),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(rng, name):
    """Value and gradient (with respect to the predictions) of each loss."""
    make, wrt, ours, ref = CASES[name]
    arrays = make(rng)
    inputs = [torch.tensor(a, requires_grad=(i == wrt)) for i, a in enumerate(arrays)]
    got = ours(*inputs)
    got.backward()

    def jax_fn(x):
        args = [jnp.asarray(a) for a in arrays]
        args[wrt] = x
        return ref(*args)

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(arrays[wrt]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(inputs[wrt].grad.numpy(), np.asarray(want_grad), atol=TOL)


def test_all_padding_losses_are_zero(rng):
    """A window of nothing but padding or ignored rows gives 0, not NaN."""
    pred, target, valid = _velocity(rng, pad_from=0)
    logits, oracle, weights = _subgoal(rng, ignore_all=True)
    stop_logits, stop_target = _stop(rng, pad_from=0)
    t = torch.from_numpy
    for value in (losses.masked_velocity_mse(t(pred), t(target)),
                  losses.validmask_velocity_mse(t(pred), t(target), t(valid)),
                  losses.masked_stop_bce(t(stop_logits), t(stop_target)),
                  losses.subgoal_cross_entropy(t(logits), t(oracle)),
                  losses.subgoal_cross_entropy(t(logits), t(oracle), t(weights))):
        assert value.item() == 0.0


def test_inflection_weights_match_jax(rng):
    """The window's first step and every sub-goal change get the
    coefficient, others 1."""
    oracle = rng.integers(0, 5, size=(3, 12)).astype(np.float32)
    got = losses.inflection_weights(torch.from_numpy(oracle), 3.2)
    want = jax_losses.inflection_weights(jnp.asarray(oracle), 3.2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fixed = torch.tensor([[2, 2, 3, 3, 3, 1], [1, 1, 1, 1, 4, 4]], dtype=torch.float32)
    np.testing.assert_allclose(losses.inflection_weights(fixed, 3.2).numpy(),
                               [[3.2, 1, 3.2, 1, 1, 3.2], [3.2, 1, 1, 1, 3.2, 1]])


@pytest.mark.parametrize("step", [0, 500, 1000, 16000, 31000])
def test_cyclic_triangular_lr_matches_jax(step):
    assert optimizers.cyclic_triangular_lr(step) == jax_opt.cyclic_triangular_lr(step)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.embedding_layer = nn.Linear(1, 1)
        self.rgb_encoder = nn.Module()
        self.rgb_encoder.cnn = nn.Linear(1, 1)
        self.depth_encoder = nn.Module()
        self.depth_encoder.visual_encoder = nn.Linear(1, 1)
        self.depth_encoder.visual_fc = nn.Linear(1, 1)
        self.linear = nn.Linear(1, 1)


@pytest.mark.parametrize("unfrozen", [(), ("embedding_layer",)])
def test_trainable_mask_matches_jax(unfrozen):
    """The frozen names of the JAX mask, over ``named_parameters`` paths;
    ``unfrozen`` lifts BERT's freeze (the case of
    tests/test_trainable_bert.py::test_trainable_mask_unfrozen_names)."""
    module = _Tiny()
    mask = optimizers.trainable_mask(module, unfrozen=unfrozen)
    tree = {"embedding_layer": {"w": 0}, "rgb_encoder": {"cnn": {"w": 0}},
            "depth_encoder": {"visual_encoder": {"w": 0}, "visual_fc": {"w": 0}},
            "linear": {"w": 0}}
    ref = jax_opt.trainable_mask(tree, unfrozen=unfrozen)
    for name, trainable in mask.items():
        node = ref
        for part in name.split(".")[:-1]:
            node = node[part]
        assert trainable == node["w"], name
    assert mask["embedding_layer.weight"] == bool(unfrozen)
    assert not mask["rgb_encoder.cnn.bias"] and mask["linear.weight"]
    params = optimizers.trainable_parameters(module, unfrozen)
    assert len(params) == sum(mask.values())
    for opt in (optimizers.adam(module, 0.0, unfrozen), optimizers.adamw(module, 1e-3, unfrozen)):
        grouped = [p for g in opt.param_groups for p in g["params"]]
        assert [id(p) for p in grouped] == [id(p) for p in params]
        assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
