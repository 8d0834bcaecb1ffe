"""The port's closed-loop flat eval (eval/evaluator.eval_flat_checkpoint, its
host driver and EVAL.ON_DEVICE) against the JAX package's
``eval_flat_checkpoint``, on the CPU.

The set-up is the tiny bidirectional CMA of tests/test_torch_flat_trainer.py
at 32 px: float32, the JAX trainer's weights carried over, its velocity head
scaled as tests/test_torch_eval.py scales the HCM agent's so that the agent
drives and episodes end on success at different ticks; three episodes on
the kinematic backend, MAX_EPISODE_STEPS 12, the success distance 4 m.

1. The host driver at NUM_ENVS 1 and 2, against the JAX package's: per
   episode ``success``, ``actual_success`` and the step count equal, every
   continuous stat within rtol 1e-4, every step's position within 1e-4 m
   (tests/test_torch_eval.py's tolerances).  The instruction is encoded
   once an episode (the JAX package re-encodes it every tick, to the same
   values).
2. The on-device eval (its tick eager on the CPU; on CUDA a CUDA graph,
   chip_smoke.py phase 11) against the host driver and the JAX package's,
   with tests/test_torch_ondevice.py's tolerances: success and
   actual_success equal, nDTW within 0.05, steps within 1.  The
   instruction encoder runs once a batch, outside the tick.
"""

import jax
import numpy as np
import pytest

from robo_vln_tpu.eval import evaluator as jax_evaluator
from robo_vln_tpu.training.trainer import RoboVLNTrainer as JaxFlatTrainer
from robo_vln_tpu.utils.logging import MetricsWriter as JaxWriter
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.eval import evaluator, ondevice
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
from robo_vln_tpu_torch.utils.logging import MetricsWriter
from robo_vln_tpu_torch.utils.weight_port import load_flat_weights
from tests.test_envs import make_episode_json
from tests.test_torch_eval import (STATS_RTOL, SUCCESS_DISTANCE, VELOCITY_BIAS, VELOCITY_SCALE,
                                   _first_divergence, _Recorder, _trajectories)
from tests.test_torch_flat_trainer import flat_opts, jax_flat_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

HW = 32
SUCCESS = {f"TASK_CONFIG.TASK.{k}SUCCESS_DISTANCE": SUCCESS_DISTANCE
           for k in ("", "SUCCESS.", "SPL.", "NDTW.")}


def flat_eval_options(data_path, n_envs=1, **extra):
    return {"TPU.PRECISION": "float32", "MODEL.CMA.use": True,
            "MODEL.INSTRUCTION_ENCODER.bidirectional": True,
            "TASK_CONFIG.SIMULATOR.TYPE": "kinematic",
            "TASK_CONFIG.DATASET.DATA_PATH": data_path,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 12,
            "EVAL.SPLIT": "train", "EVAL.EPISODE_COUNT": 3, "EVAL.NUM_ENVS": n_envs,
            "EVAL.DUMP_TRAJECTORIES": True, **SUCCESS, **extra}


def _scaled(jt):
    """The JAX trainer's variables with the velocity head scaled (both
    packages get these weights), as numpy."""
    params = jax.tree.map(np.asarray, jax.device_get(jt.state.params))
    params["linear"] = {"kernel": params["linear"]["kernel"] * VELOCITY_SCALE,
                        "bias": params["linear"]["bias"] + np.float32(VELOCITY_BIAS)}
    jt.state = jt.state._replace(params=params)
    return {"params": params, **jax.tree.map(np.asarray, jt.extra_variables)}


def carried_trainers(tmp_path, data, n_envs=1, **extra):
    jcfg = jax_flat_config(tmp_path / "jax", hw=HW, **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "jax" / "val"),
        **flat_eval_options(data, n_envs, **extra)})
    jt = JaxFlatTrainer(jcfg)
    jt._setup_policy()
    variables = _scaled(jt)
    pcfg = get_config(opts=flat_opts(tmp_path / "port", hw=HW, batch_size=1, **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "port" / "val"),
        **flat_eval_options(data, n_envs, **extra)}))
    pt = RoboVLNTrainer(pcfg)
    pt._setup_policy()
    load_flat_weights(pt.policy, variables)
    return jt, pt


@pytest.mark.parametrize("n_envs", [1, 2])
def test_flat_eval_matches_jax(tmp_path, monkeypatch, n_envs):
    data = make_episode_json(tmp_path, n_eps=3)
    jt, pt = carried_trainers(tmp_path, data, n_envs)
    jax_rec = _Recorder(jax_evaluator, monkeypatch)
    with JaxWriter(jt.config.TENSORBOARD_DIR) as writer:
        jax_stats = jax_evaluator.eval_flat_checkpoint(jt, "", writer, 0)
    port_rec = _Recorder(evaluator, monkeypatch)
    encodes = []
    original = pt.policy.encode_instruction
    monkeypatch.setattr(pt.policy, "encode_instruction",
                        lambda ids, generator=None: encodes.append(1) or original(ids))
    with MetricsWriter(pt.config.TENSORBOARD_DIR) as writer:
        port_stats = evaluator.eval_flat_checkpoint(pt, "", writer, 0)

    prows = _trajectories(pt.config.TENSORBOARD_DIR)
    jrows = _trajectories(jt.config.TENSORBOARD_DIR)
    assert prows.keys() == jrows.keys() == {"0", "1", "2"}
    diverged = _first_divergence(prows, jrows)
    assert diverged is None, "positions diverge at episode %s step %d by %.3e m" % diverged
    for ep, j in jrows.items():
        for k in ("success", "actual_success", "steps"):
            assert prows[ep][k] == j[k], f"episode {ep}: {k} {prows[ep][k]} against JAX {j[k]}"
    assert port_rec.episodes.keys() == jax_rec.episodes.keys()
    for ep, j in jax_rec.episodes.items():
        assert port_rec.episodes[ep].keys() == j.keys()
        for k, v in j.items():
            np.testing.assert_allclose(port_rec.episodes[ep][k], v, rtol=STATS_RTOL,
                                       atol=1e-12, err_msg=f"episode {ep} {k}")
    assert port_stats.keys() == jax_stats.keys()
    for k, v in jax_stats.items():
        if k == "pretrained_backbones":
            assert port_stats[k] == v
        else:
            np.testing.assert_allclose(port_stats[k], v, rtol=STATS_RTOL, err_msg=k)
    assert {int(r["steps"]) for r in jrows.values()} != {13}
    assert any(r["actual_success"] for r in jrows.values())
    assert jax_stats["path_length"] > 0.5
    # the ids change when an env's episode changes: far fewer than ticks
    assert 0 < len(encodes) <= 4 + n_envs


def test_flat_ondevice_eval_matches_host_and_jax(tmp_path, monkeypatch):
    data = make_episode_json(tmp_path, n_eps=3)
    on_device = {"EVAL.ON_DEVICE": True, "EVAL.ON_DEVICE_BATCH": 2}
    jt, pt = carried_trainers(tmp_path, data, **on_device)
    jax_rec = _Recorder(jax_evaluator, monkeypatch)
    with JaxWriter(jt.config.TENSORBOARD_DIR) as writer:
        jax_stats = jax_evaluator.eval_flat_checkpoint(jt, "", writer, 0)
    port_rec = _Recorder(evaluator, monkeypatch)
    rollouts = []
    original = ondevice.Rollout.__init__

    def keep(self, *args, **kwargs):
        original(self, *args, **kwargs)
        rollouts.append(self)

    monkeypatch.setattr(ondevice.Rollout, "__init__", keep)
    fused_lstm.reset_launches()
    with MetricsWriter(pt.config.TENSORBOARD_DIR) as writer:
        dev_stats = evaluator.eval_flat_checkpoint(pt, "", writer, 0)
    dev_episodes = port_rec.episodes
    (rollout,) = rollouts
    assert [b["ticks"] <= 12 for b in rollout.batches] == [True, True]
    assert fused_lstm.launches == 0  # the CPU runs the plain version
    cfg = pt.config.clone().defrost()
    cfg.EVAL.ON_DEVICE = False
    cfg.EVAL.VAL_LOG_DIR = str(tmp_path / "host_val")
    pt.config = cfg.freeze()
    with MetricsWriter(str(tmp_path / "host_tb")) as writer:
        host_stats = evaluator.eval_flat_checkpoint(pt, "", writer, 0)

    assert set(dev_stats) == set(host_stats) == set(jax_stats)
    assert dev_episodes.keys() == jax_rec.episodes.keys() == {"0", "1", "2"}
    for ep, ref in jax_rec.episodes.items():
        got = dev_episodes[ep]
        assert got["success"] == ref["success"]
        assert got["actual_success"] == ref["actual_success"], ep
        assert got["ndtw"] == pytest.approx(ref["ndtw"], abs=0.05)
        assert got["steps_taken"] == pytest.approx(ref["steps_taken"], abs=1.0)
    for ref in (jax_stats, host_stats):
        assert dev_stats["success"] == ref["success"]
        assert dev_stats["actual_success"] == ref["actual_success"]
        assert dev_stats["ndtw"] == pytest.approx(ref["ndtw"], abs=0.05)
        assert dev_stats["steps_taken"] == pytest.approx(ref["steps_taken"], abs=1.0)
    steps = {st["steps_taken"] for st in dev_episodes.values()}
    assert len(steps) > 1 and any(st["actual_success"] for st in dev_episodes.values())
    assert dev_stats["path_length"] > 0.5
