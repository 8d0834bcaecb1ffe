"""The nonlearning agents (agents/nonlearning.py, nonlearning.yaml through
``run_exp --run-type eval``) against the JAX package's evaluate_agent, on
the CPU: the same three synthetic episodes on the kinematic backend (32 px
sensors, at most 60 steps), each agent's actions equal tick by tick (the
expert's within 1e-12: its controller's float64 arithmetic runs in another
order, as tests/test_torch_collection.py finds), and
``stats_complete_<agent>_<split>.json`` with the same keys and every value
within 1e-6."""

import json

import numpy as np
import pytest

from robo_vln_tpu.agents import nonlearning as jax_nonlearning
from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu_torch.agents import nonlearning
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.run import run_exp
from tests.test_envs import make_episode_json
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import PORT_CONFIGS, REPO

STATS_TOL = 1e-6
SPLIT = "val_unseen"  # nonlearning.yaml's


def _opts(tmp_path, agent, tag):
    data = make_episode_json(tmp_path, n_eps=3)
    opts = {"TASK_CONFIG.SIMULATOR.TYPE": "kinematic", "TASK_CONFIG.DATASET.DATA_PATH": data,
            "TASK_CONFIG.DATASET.SCENES_DIR": str(tmp_path),
            "TASK_CONFIG.TASK.NDTW.GT_PATH": str(tmp_path / "no_gt.json.gz"),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 60, "EVAL.EPISODE_COUNT": 3,
            "EVAL.NONLEARNING.AGENT": agent, "EVAL.VAL_LOG_DIR": str(tmp_path / tag),
            "LOG_FILE": str(tmp_path / f"{tag}.log"),
            **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": 32
               for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")}}
    return [str(x) for kv in opts.items() for x in kv]


def _recording(monkeypatch, module, log):
    for cls in (module.RandomContinuousAgent, module.HandcraftedAgent, module.ExpertAgent):
        act = cls.act
        monkeypatch.setattr(cls, "act", lambda self, env=None, _act=act: (
            log.append(_act(self, env)) or log[-1]))


@pytest.mark.parametrize("agent", ["RandomAgent", "HandcraftedAgent", "ExpertAgent"])
def test_nonlearning_agents_match_jax(tmp_path, monkeypatch, agent):
    monkeypatch.chdir(REPO)  # the JAX yamls name their task config from the repo root
    jax_actions, port_actions = [], []
    _recording(monkeypatch, jax_nonlearning, jax_actions)
    _recording(monkeypatch, nonlearning, port_actions)
    jcfg = jax_get_config(str(REPO / "robo_vln_tpu/config/configs/nonlearning.yaml"),
                          _opts(tmp_path, agent, "jax"))
    want = jax_nonlearning.evaluate_agent(jcfg)
    run_exp(str(PORT_CONFIGS / "nonlearning.yaml"), "eval", _opts(tmp_path, agent, "port"))

    assert len(port_actions) == len(jax_actions) > 3
    np.testing.assert_allclose(np.asarray(port_actions), np.asarray(jax_actions), rtol=0,
                               atol=1e-12 if agent == "ExpertAgent" else 0)
    name = f"stats_complete_{agent}_{SPLIT}.json"
    got = json.loads((tmp_path / "port" / name).read_text())
    assert json.loads((tmp_path / "jax" / name).read_text()) == want
    assert got.keys() == want.keys() and {"ndtw", "success", "spl"} <= got.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=STATS_TOL, err_msg=key)
    assert got["path_length"] > 0


def test_nonlearning_yaml_is_the_jax_packages():
    """The port's nonlearning.yaml is a byte copy, and get_config takes its
    keys, EVAL.EVAL_NONLEARNING and EVAL.NONLEARNING.AGENT, which the port
    once refused."""
    ours = (PORT_CONFIGS / "nonlearning.yaml").read_bytes()
    assert ours == (REPO / "robo_vln_tpu/config/configs/nonlearning.yaml").read_bytes()
    cfg = get_config(str(PORT_CONFIGS / "nonlearning.yaml"),
                     ["EVAL.NONLEARNING.AGENT", "ExpertAgent"])
    assert cfg.EVAL.EVAL_NONLEARNING is True and cfg.EVAL.NONLEARNING.AGENT == "ExpertAgent"
    with pytest.raises(ValueError, match="EVAL.NONLEARNING.AGENT"):
        nonlearning.evaluate_agent(get_config(opts=["EVAL.NONLEARNING.AGENT", "Oracle"]))
