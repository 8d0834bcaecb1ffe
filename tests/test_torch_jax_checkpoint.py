"""scripts/jax_checkpoint_to_torch.py: a JAX package checkpoint resumed on the
port.

The tiny JAX HCM (tests/test_torch_agent.jax_tiny_hcm's sizes, dropout off)
and a tiny flat CMA take K train steps through the JAX package's steps, are
saved as the JAX trainers save them (orbax train state, the frozen BatchNorm
statistics beside it, the metadata with the config and the loop counters)
and converted.  The port loads the converted checkpoint as its trainers do
(training/checkpoint.py, optimizers built over the trainable parameters):
the weights are JAX's bitwise, the Adam moments and steps JAX's exactly,
the counters carried.  Then both take one more step on the same batch, and
the parameters and Adam moments agree within 1e-5 in float32."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.training import checkpoint as jax_ckpt
from robo_vln_tpu.training import steps as jax_steps
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.utils.weight_port import (
    flat_state_dict,
    high_level_state_dict,
    low_level_state_dict,
)
from tests import test_torch_flat_train as flat
from tests import test_torch_train_step as hier
from tests.test_torch_agent import PX
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
K = 2  # JAX steps before the checkpoint
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COUNTERS = {"scheduler_step": 7, "train_steps": K, "val_steps": 3}


def converter():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", os.path.join(REPO, "scripts", "jax_checkpoint_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_config(model_config, trainer, px):
    """The JAX trainer's config around a tiny MODEL stanza, as it records it."""
    cfg = jax_get_config().clone().defrost()
    cfg.MODEL = model_config.clone().defrost()
    cfg.TRAINER_NAME = trainer
    for sensor in ("RGB_SENSOR", "DEPTH_SENSOR"):
        cfg.TASK_CONFIG.SIMULATOR[sensor].WIDTH = cfg.TASK_CONFIG.SIMULATOR[sensor].HEIGHT = px
    return cfg


def _save(path, state, cfg, extra):
    jax_ckpt.save_checkpoint(path, state, metadata={"config": cfg.to_dict(), **COUNTERS})
    jax_ckpt.save_extra_variables(path, extra)


def _numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _check(module, optimizer, level_state, variables, to_sd, exact, what):
    """The port level against the JAX level: parameters, Adam moments and
    step (bitwise when ``exact``, else within TOL)."""
    extras = {k: v for k, v in variables.items() if k != "params"}
    moments = hier._adam_moments(level_state.opt_state)
    want_p = hier._port_names(_numpy(level_state.params), variables, to_sd)
    want_mu = hier._port_names(moments.mu, {**extras, "params": variables["params"]}, to_sd)
    want_nu = hier._port_names(moments.nu, {**extras, "params": variables["params"]}, to_sd)
    names = {id(p): n for n, p in module.named_parameters()}
    checked = 0
    for p in (p for g in optimizer.param_groups for p in g["params"]):
        name = names[id(p)]
        if name not in want_p:  # never created by the flax policy: no moment
            assert p not in optimizer.state, name
            continue
        st = optimizer.state[p]
        assert int(st["step"]) == int(moments.count), name
        for got, want, label in ((p.detach(), want_p[name], "param"),
                                 (st["exp_avg"], want_mu[name], "mu"),
                                 (st["exp_avg_sq"], want_nu[name], "nu")):
            got = got.numpy()
            want = np.asarray(want, np.float32)
            if exact:
                assert np.array_equal(got, want), f"{what} {label} {name}"
            else:
                np.testing.assert_allclose(got, want, atol=TOL, err_msg=f"{what} {label} {name}")
        checked += 1
    assert checked


def test_hierarchical_checkpoint_resumes_on_the_port(tmp_path):
    jax_mc, jhigh, jlow, high_vars, low_vars = hier.jax_setup()
    jmc = jax_mc.clone().defrost()
    jmc.TRANSFORMER.weight_decay = hier.WD
    jstep, _, tx_h, tx_l = hier.jax_programs(False)
    hp, lp = high_vars["params"], low_vars["params"]
    jstate = jax_steps.HierTrainState(
        jax_steps.TrainState(hp, tx_h.init(hp), jnp.asarray(0)),
        jax_steps.TrainState(lp, tx_l.init(lp), jnp.asarray(0)))
    rng = np.random.default_rng(21)
    for window in range(K):
        batch = jax.tree.map(jnp.asarray, hier.make_batch(rng, window))
        jstate, _, _, _ = jstep(jstate, jhigh.initial_hidden(hier.B), jlow.initial_hidden(hier.B),
                                batch, hier.LR, hier.LR)
    jax_dir, out = str(tmp_path / "jax" / "ckpt.3"), str(tmp_path / "port" / "ckpt.3")
    _save(jax_dir, jstate, jax_config(jmc, "hierarchical_trainer", PX),
          {"high": hier._extras(high_vars), "low": hier._extras(low_vars)})
    meta = converter().convert(jax_dir, out)
    assert {k: meta[k] for k in COUNTERS} == COUNTERS
    assert ckpt_lib.load_metadata(out)["scheduler_step"] == COUNTERS["scheduler_step"]

    high, low, state, step, _ = hier.port_setup(weights=False)
    state = ckpt_lib.load_checkpoint(out, high, low, state)
    assert (state.high.step, state.low.step) == (K, K)
    levels = (("high", high, high_vars, high_level_state_dict),
              ("low", low, low_vars, low_level_state_dict))
    for (what, module, variables, to_sd), opt, jlevel in zip(
            levels, (state.high.optimizer, state.low.optimizer), jstate):
        _check(module, opt, jlevel, variables, to_sd, exact=True, what=what)
        want = to_sd(_numpy({**hier._extras(variables), "params": jlevel.params}))
        for name, t in module.state_dict().items():  # frozen trunks and BN statistics too
            if name in want:
                assert np.array_equal(t.numpy(), np.asarray(want[name], np.float32)), name

    batch = hier.make_batch(rng, 1)
    jstate, _, _, _ = jstep(jstate, jhigh.initial_hidden(hier.B), jlow.initial_hidden(hier.B),
                            jax.tree.map(jnp.asarray, batch), hier.LR, hier.LR)
    state, _, _, _ = step(state, high.initial_hidden(hier.B), low.initial_hidden(hier.B),
                          hier._torch(batch), hier.LR, hier.LR)
    assert (state.high.step, state.low.step) == (K + 1, K + 1)
    for (what, module, variables, to_sd), opt, jlevel in zip(
            levels, (state.high.optimizer, state.low.optimizer), jstate):
        _check(module, opt, jlevel, variables, to_sd, exact=False, what=what)


def test_flat_checkpoint_resumes_on_the_port(tmp_path):
    case = "cma_bi"
    px, overrides = flat.CASES[case]
    jax_mc, _, jpolicy, variables, _ = flat.jax_flat(px, overrides)
    jstep, _, tx, _ = flat.jax_programs(case)
    params = variables["params"]
    jstate = jax_steps.TrainState(params, tx.init(params), jnp.asarray(0))
    rng = np.random.default_rng(22)
    hidden0 = jpolicy.initial_hidden(flat.B)
    for window in range(K):
        batch = jax.tree.map(jnp.asarray, flat.make_flat_batch(rng, px, window))
        jstate, _, _ = jstep(jstate, hidden0, batch, flat.LR)
    jax_dir, out = str(tmp_path / "jax" / "ckpt.5"), str(tmp_path / "port" / "ckpt.5")
    _save(jax_dir, jstate, jax_config(jax_mc, "robo_vln_trainer", px), hier._extras(variables))
    meta = converter().convert(jax_dir, out)
    assert {k: meta[k] for k in COUNTERS} == COUNTERS

    policy, state, step = flat.port_setup(case)
    state = ckpt_lib.load_flat_checkpoint(out, policy, state)
    assert state.step == K
    _check(policy, state.optimizer, jstate, variables, flat_state_dict, exact=True, what="flat")

    batch = flat.make_flat_batch(rng, px, 1)
    jstate, _, _ = jstep(jstate, hidden0, jax.tree.map(jnp.asarray, batch), flat.LR)
    state, _, _ = step(state, policy.initial_hidden(flat.B), flat._torch(batch), flat.LR)
    _check(policy, state.optimizer, jstate, variables, flat_state_dict, exact=False, what="flat")


def test_converter_helpers():
    conv = converter()
    like = {"a": np.zeros(2, np.float32), "b": np.ones((1, 2), np.float32)}
    filled = conv._fill({"a": np.ones(2, np.float32), "b": None}, like)
    assert np.array_equal(filled["a"], np.ones(2)) and np.isnan(filled["b"]).all()
    with pytest.raises(ValueError, match="one Adam state"):
        conv.adam_moments([{"inner_state": None}])
