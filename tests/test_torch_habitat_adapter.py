"""The port's HabitatEnv adapter (envs/env.py) against the JAX package's,
on the CPU, under the same mocked ``habitat``/``habitat_sim`` modules of
tests/test_habitat_adapter.py (the fork API pinned in both docstrings):
both adapters, built through each package's construct_env, are driven
through the same reset and steps, and must make the same calls into the
mocked modules (config handoff, action dicts, VelocityControl fields, the
fork-style integration and set_agent_state) and return the same
observations, done pairs, infos, agent states and geodesics."""

import numpy as np
import pytest

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.envs.env_utils import construct_env as jax_construct_env
from robo_vln_tpu.envs.velocity_control import VelocityControl as JaxVelocityControl
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.envs.env import HabitatEnv
from robo_vln_tpu_torch.envs.env_utils import construct_env
from robo_vln_tpu_torch.envs.velocity_control import VelocityControl
from tests.test_habitat_adapter import _FakeVelocityControl, _install_fakes
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MEASURES = ["DISTANCE_TO_GOAL", "SUCCESS"]


def _config(get, measures):
    cfg = get().clone().defrost()
    cfg.TASK_CONFIG.SIMULATOR.TYPE = "habitat"
    cfg.TASK_CONFIG.TASK.MEASUREMENTS = list(measures)
    cfg.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS = 3
    return cfg.freeze()


def _plain(x):
    """A log entry as comparable values: mocked objects by their fields."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "init_dict"):  # habitat.Config(init_dict=...)
        return {"init_dict": _plain(x.init_dict)}
    if hasattr(x, "calls"):  # the yacs node
        return {"calls": list(x.calls), "merged": _plain(x.merged)}
    if isinstance(x, _FakeVelocityControl):
        return _plain(dict(vars(x)))
    return x


def _drive(monkeypatch, with_vc_action, build, config, vc_type):
    log = []
    _install_fakes(monkeypatch, log, with_vc_action)
    env = build(config)
    out = {"reset": env.reset(), "state": env.get_agent_state(),
           "position": env.get_agent_position(),
           "geodesic": env.geodesic_distance([0, 0, 0], [3.0, 0, 4.0]), "steps": []}
    for lin, ang in ((-0.9, 0.4), (-0.5, -0.2), (0.0, 0.0), (-1.0, 1.0)):
        vc = vc_type()
        vc.linear_velocity = np.array([0.0, 0.0, lin])
        vc.angular_velocity = np.array([0.0, ang, 0.0])
        out["steps"].append(env.step(vc))
        if with_vc_action is False:
            out["steps"].append(_FakeVelocityControl.integrated)
    out["episode"] = env.current_episode.episode_id
    env.close()
    return env, log, out


@pytest.mark.parametrize("with_vc_action", [True, False])
@pytest.mark.parametrize("measures", [[], MEASURES])
def test_habitat_adapter_matches_jax(monkeypatch, with_vc_action, measures):
    jenv, jlog, jout = _drive(monkeypatch, with_vc_action, jax_construct_env,
                              _config(jax_get_config, measures), JaxVelocityControl)
    penv, plog, pout = _drive(monkeypatch, with_vc_action, construct_env,
                              _config(get_config, measures), VelocityControl)
    assert isinstance(penv, HabitatEnv)
    assert len(plog) == len(jlog)
    for p, j in zip(plog, jlog):
        if p[0] == "Env":  # the port's task tree has the same keys and values
            assert _plain(p[1])["calls"] == _plain(j[1])["calls"]
            assert _plain(p[1])["merged"] == _plain(j[1])["merged"]
        else:
            assert _plain(p) == _plain(j)
    np.testing.assert_array_equal(pout["state"].rotation, jout["state"].rotation)
    np.testing.assert_array_equal(pout["state"].position, jout["state"].position)
    np.testing.assert_array_equal(pout["position"], jout["position"])
    assert pout["geodesic"] == jout["geodesic"] == pytest.approx(5.0)
    assert pout["episode"] == jout["episode"]
    assert _plain(pout["reset"]) == _plain(jout["reset"])
    assert len(pout["steps"]) == len(jout["steps"])
    for p, j in zip(pout["steps"], jout["steps"]):
        if isinstance(p, tuple) and len(p) == 4:
            (p_obs, p_r, p_done, p_info), (j_obs, j_r, j_done, j_info) = p, j
            assert _plain(p_obs) == _plain(j_obs) and p_r == j_r == 0.0
            assert p_done == j_done and p_info == j_info
            assert p_info["fake_metric"] == 1.0 and set(p_info) >= {m.lower() for m in
                                                                     measures}
        else:  # the fork-style integration's (dt, rigid state)
            assert p[0] == j[0]
            np.testing.assert_array_equal(p[1].position, j[1].position)
    # the step cap ends the episode at MAX_EPISODE_STEPS, as in JAX
    dones = [s[2][0] for s in pout["steps"] if isinstance(s, tuple) and len(s) == 4]
    assert dones == [False, False, True, True]
