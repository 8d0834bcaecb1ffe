"""The port's on-device eval (eval/ondevice.py and EVAL.ON_DEVICE in
eval/evaluator.py) against the JAX package's on the CPU, where the tick runs
eagerly (on CUDA each batch replays a CUDA graph of it: chip_smoke.py
phase 10).

1. The sim math: quaternion product and rotation, the rigid-state
   integration and the heading within 1e-6 of the JAX package's and of the
   host sim's float64 (the inputs rounded to float32 first); the polyline
   distance within 1e-6 (relative) of the JAX package's and 1e-4 m of the
   host's; the render's rgb within one level and its depth within one
   float16 ulp of the JAX package's.
2. The on-device eval of the tiny HCM of tests/test_torch_eval.py (the JAX
   trainer's weights carried over, the velocity head scaled so that the
   agent drives and episodes end on success at different ticks) against the
   JAX package's on-device eval and against the port's host driver, with
   the tolerances of tests/test_ondevice.py: success and actual_success
   equal, nDTW within 0.05, steps within 1.
3. Ticks past the end change nothing, n_ticks is max(steps), the last batch
   is padded; a non-kinematic backend warns and runs the host driver; the
   rollout's LSTM launches go through its own workspace, which the shared
   workspace's growth does not touch.
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.envs.env import _PolylineGeodesics as HostGeodesics
from robo_vln_tpu.envs.velocity_control import (
    RigidState,
    VelocityControl,
    heading_from_quaternion as host_heading,
    integrate_rigid_state as host_integrate,
)
from robo_vln_tpu.eval import evaluator as jax_evaluator
from robo_vln_tpu.eval import ondevice as jax_ondevice
from robo_vln_tpu.training.hierarchical_trainer import HierarchicalTrainer as JaxTrainer
from robo_vln_tpu.utils.logging import MetricsWriter as JaxWriter
from robo_vln_tpu_torch.eval import evaluator, ondevice
from robo_vln_tpu_torch.ops import fused_lstm
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.utils.logging import MetricsWriter
from robo_vln_tpu_torch.utils.weight_port import load_hierarchical_weights
from tests.test_envs import make_episode_json
from tests.test_torch_eval import (
    SUCCESS_DISTANCE,
    _Recorder,
    _scaled_velocity_head,
    eval_options,
    port_cfg,
)
from tests.test_torch_trainer import jax_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

MATH_TOL = 1e-6
DT = 1 / 30
ON_DEVICE = {"EVAL.ON_DEVICE": True, "EVAL.ON_DEVICE_BATCH": 2}
# the on-device measures take success at NDTW.SUCCESS_DISTANCE, the host's at
# SUCCESS.SUCCESS_DISTANCE (both packages): all four set alike
SUCCESS = {f"TASK_CONFIG.TASK.{k}SUCCESS_DISTANCE": SUCCESS_DISTANCE
           for k in ("", "SUCCESS.", "SPL.", "NDTW.")}


def _unit_quaternions(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_sim_math_matches_jax_and_host(rng):
    n = 8
    q = _unit_quaternions(rng, n)
    q2 = _unit_quaternions(rng, n)
    p, lin, ang, v = (rng.standard_normal((n, 3)).astype(np.float32) for _ in range(4))
    ang[0] = 0.0  # no rotation: the pose keeps its quaternion
    np.testing.assert_allclose(ondevice.quat_mul(_t(q), _t(q2)).numpy(),
                               np.asarray(jax_ondevice.quat_mul(q, q2)), atol=MATH_TOL)
    np.testing.assert_allclose(ondevice.quat_rotate(_t(q), _t(v)).numpy(),
                               np.asarray(jax_ondevice.quat_rotate(q, v)), atol=MATH_TOL)
    got_q, got_p = (x.numpy() for x in ondevice.integrate_rigid_state(
        _t(q), _t(p), _t(lin), _t(ang), DT))
    ref_q, ref_p = (np.asarray(x) for x in jax_ondevice.integrate_rigid_state(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(lin), jnp.asarray(ang), DT))
    np.testing.assert_allclose(got_q, ref_q, atol=MATH_TOL)
    np.testing.assert_allclose(got_p, ref_p, atol=MATH_TOL)
    np.testing.assert_array_equal(got_q[0], q[0])
    heading = ondevice.heading_from_quaternion(_t(q)).numpy()
    np.testing.assert_allclose(heading, np.asarray(jax_ondevice.heading_from_quaternion(
        jnp.asarray(q))), atol=MATH_TOL)
    for i in range(n):
        host = host_integrate(RigidState(q[i].astype(np.float64), p[i].astype(np.float64)),
                              VelocityControl(lin[i].astype(np.float64),
                                              ang[i].astype(np.float64)), DT)
        np.testing.assert_allclose(got_q[i], host.rotation, atol=MATH_TOL)
        np.testing.assert_allclose(got_p[i], host.position, atol=MATH_TOL)
        assert heading[i] == pytest.approx(host_heading(q[i].astype(np.float64)), abs=MATH_TOL)


def test_polyline_distance_matches_jax_and_host(rng):
    pts = np.array([[0, 0, 0], [0, 0, -3], [2, 0, -5], [2, 0, -8]], np.float64)
    K = 7  # padded by repeating the goal, as pack_episodes pads
    padded = np.concatenate([pts, np.repeat(pts[-1:], K - len(pts), 0)])[None]
    padded = np.repeat(padded, 8, axis=0).astype(np.float32)
    seg = np.linalg.norm(padded[:, 1:] - padded[:, :-1], axis=-1)
    cum = np.concatenate([np.zeros((8, 1)), np.cumsum(seg, axis=1)], axis=1).astype(np.float32)
    p = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
    p[0] = pts[1]  # on a vertex: two segments tie, the first is taken
    goal = padded[:, -1]
    got = ondevice.polyline_distance(_t(padded), _t(cum), _t(p), _t(goal)).numpy()
    ref = np.asarray(jax_ondevice.polyline_distance(padded, cum, p, goal))
    np.testing.assert_allclose(got, ref, rtol=MATH_TOL, atol=MATH_TOL)
    host = HostGeodesics(pts)
    np.testing.assert_allclose(got, [host.distance(x, pts[-1]) for x in p], atol=1e-4)


@pytest.mark.parametrize("hw", [(32, 32), (56, 56)])
def test_render_matches_jax(rng, hw):
    pos = rng.standard_normal((4, 3)).astype(np.float32) * 3
    heading = rng.uniform(-np.pi, np.pi, 4).astype(np.float32)
    depth_hw = (hw[0] + 8, hw[0] + 8)
    rgb, depth = ondevice.render_obs(_t(pos), _t(heading), hw, depth_hw)
    ref_rgb, ref_depth = jax_ondevice.render_obs(jnp.asarray(pos), jnp.asarray(heading), hw,
                                                 depth_hw)
    assert rgb.dtype == torch.uint8 and tuple(rgb.shape) == (4, *hw, 3)
    assert depth.dtype == torch.float16 and tuple(depth.shape) == (4, *depth_hw, 1)
    assert np.abs(rgb.numpy().astype(np.int16) - np.asarray(ref_rgb, np.int16)).max() <= 1
    ulp = np.spacing(np.abs(np.asarray(ref_depth)))
    assert (np.abs(depth.numpy().astype(np.float32) - np.asarray(ref_depth, np.float32))
            <= ulp).all()


def _carried_trainers(tmp_path, data, **extra):
    """(JAX trainer and config, port trainer and config) over ``data``, the
    port holding the JAX trainer's weights (the velocity head scaled)."""
    jcfg = jax_config(tmp_path / "jax", **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "jax" / "val"),
        **eval_options(data, 1, **SUCCESS, **extra)})
    jt = JaxTrainer(jcfg)
    jt._setup_policy()
    high_vars, low_vars = _scaled_velocity_head(jt)
    pcfg = port_cfg(tmp_path / "port", data, 1, **SUCCESS, **extra)
    pt = HierarchicalTrainer(pcfg)
    pt._setup_policy()
    load_hierarchical_weights(pt.high, pt.low, high_vars, low_vars)
    return jt, pt


def _with(trainer, **options):
    cfg = trainer.config.clone().defrost()
    for key, value in options.items():
        node = cfg
        *path, leaf = key.split(".")
        for part in path:
            node = getattr(node, part)
        setattr(node, leaf, value)
    cfg.freeze()
    trainer.config = cfg
    return cfg


def test_ondevice_eval_matches_jax_and_host(tmp_path, monkeypatch):
    data = make_episode_json(tmp_path, n_eps=3)
    jt, pt = _carried_trainers(tmp_path, data, **ON_DEVICE)
    jax_rec = _Recorder(jax_evaluator, monkeypatch)
    with JaxWriter(jt.config.TENSORBOARD_DIR) as writer:
        jax_stats = jax_evaluator.eval_hierarchical_checkpoint(jt, "", writer, 0)
    port_rec = _Recorder(evaluator, monkeypatch)
    rollouts = []
    original = ondevice.Rollout.__init__

    def keep(self, *args, **kwargs):
        original(self, *args, **kwargs)
        rollouts.append(self)

    monkeypatch.setattr(ondevice.Rollout, "__init__", keep)
    with MetricsWriter(pt.config.TENSORBOARD_DIR) as writer:
        dev_stats = evaluator.eval_hierarchical_checkpoint(pt, "", writer, 0)
    dev_episodes = port_rec.episodes
    (rollout,) = rollouts
    # 3 episodes in batches of 2: the last batch padded with its final episode
    assert [b["ticks"] <= 12 for b in rollout.batches] == [True, True]
    _with(pt, **{"EVAL.ON_DEVICE": False, "EVAL.VAL_LOG_DIR": str(tmp_path / "host_val")})
    with MetricsWriter(str(tmp_path / "host_tb")) as writer:
        host_stats = evaluator.eval_hierarchical_checkpoint(pt, "", writer, 0)

    assert set(dev_stats) == set(host_stats) == set(jax_stats)
    assert dev_episodes.keys() == jax_rec.episodes.keys() == {"0", "1", "2"}
    for ep, ref in jax_rec.episodes.items():
        got = dev_episodes[ep]
        assert got.keys() == ref.keys()
        assert got["success"] == ref["success"] and \
            got["actual_success"] == ref["actual_success"], ep
        assert got["ndtw"] == pytest.approx(ref["ndtw"], abs=0.05)
        assert got["steps_taken"] == pytest.approx(ref["steps_taken"], abs=1.0)
        # both are the same float32 device sim: here every stat agrees closely
        for key, value in ref.items():
            np.testing.assert_allclose(got[key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=f"episode {ep} {key}")
    for ref in (jax_stats, host_stats):
        assert dev_stats["success"] == ref["success"]
        assert dev_stats["actual_success"] == ref["actual_success"]
        assert dev_stats["ndtw"] == pytest.approx(ref["ndtw"], abs=0.05)
        assert dev_stats["steps_taken"] == pytest.approx(ref["steps_taken"], abs=1.0)
    # the rollouts test what they should: the agent drove, and episodes end
    # on success at different ticks
    steps = {st["steps_taken"] for st in dev_episodes.values()}
    assert len(steps) > 1 and any(st["actual_success"] for st in dev_episodes.values())
    assert dev_stats["path_length"] > 0.5
    with open(tmp_path / "port" / "tb" / "trajectories.jsonl") as f:
        rows = {r["episode_id"]: r for r in map(json.loads, f)}
    assert {k: r["steps"] for k, r in rows.items()} == {
        k: int(st["steps_taken"]) + 1 for k, st in dev_episodes.items()}


def test_ticks_past_the_end_change_nothing(tmp_path):
    data = make_episode_json(tmp_path, n_eps=2)
    cfg = port_cfg(tmp_path, data, 1, **ON_DEVICE, **SUCCESS)
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    with torch.no_grad():  # a slow agent, so that the run ends at MAX_EPISODE_STEPS
        trainer.low.linear.bias.zero_()
    from robo_vln_tpu_torch.data.dataset import VLNCEDatasetV1
    from robo_vln_tpu_torch.eval.agent import HCMAgent

    agent = HCMAgent(trainer.high, trainer.low)
    rollout = ondevice.Rollout(agent.step, cfg, 2, agent.initial_state(2), "cpu")
    episodes = VLNCEDatasetV1(config=cfg.TASK_CONFIG.DATASET).episodes
    ids = np.tile(np.arange(1, 13, dtype=np.int32), (2, 1))
    rollout.load(ondevice.pack_episodes(episodes, 4), ids,
                 agent.embed_instruction(torch.from_numpy(ids)))
    result = rollout.run()
    assert result["n_ticks"] == int(result["steps"].max()) == 12
    assert rollout.batches[-1]["replays"] == 3 and rollout.batches[-1]["syncs"] == 4
    after = rollout.snapshot()
    for _ in range(5):
        rollout.tick()
    for key, value in rollout.snapshot().items():
        for a, b in zip(*((v,) if key != "hidden" else v for v in (after[key], value))):
            assert torch.equal(a, b), key
    # one episode done early: its pose, states and prev freeze, its trace stops
    rollout.reset()
    for _ in range(3):
        rollout.tick()
    rollout.state["done"][0] = True
    frozen = rollout.snapshot()
    rollout.tick()
    for key in ("q", "p", "prev"):
        assert torch.equal(rollout.state[key][0], frozen[key][0]), key
        assert not torch.equal(rollout.state[key][1], frozen[key][1]), key
    assert rollout.state["steps"].tolist() == [3, 4]


def test_non_kinematic_backend_runs_the_host_driver(tmp_path, monkeypatch, caplog):
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=2), 1, **ON_DEVICE)
    trainer = HierarchicalTrainer(cfg)
    _with(trainer, **{"TASK_CONFIG.SIMULATOR.TYPE": "replay"})
    calls = []
    monkeypatch.setattr(evaluator, "construct_envs", lambda config, num_envs: ["env"])
    monkeypatch.setattr(evaluator, "_run_rollout",
                        lambda config, envs, *args: calls.append(envs) or {"ndtw": 0.5})
    monkeypatch.setattr(evaluator, "_eval_on_device",
                        lambda *args: pytest.fail("the on-device driver ran"))
    with caplog.at_level(logging.WARNING, logger="robo_vln_tpu_torch"):
        with MetricsWriter(cfg.TENSORBOARD_DIR) as writer:
            stats = evaluator.eval_hierarchical_checkpoint(trainer, "", writer, 0)
    assert calls == [["env"]] and stats == {"ndtw": 0.5}
    assert "EVAL.ON_DEVICE needs the kinematic backend" in caplog.text


def test_rollout_holds_its_own_workspace(tmp_path, monkeypatch):
    """On the CPU no kernel launches: an LSTM stand-in asks for the
    workspace a launch would take, as lstm_seq_cuda does."""
    data = make_episode_json(tmp_path, n_eps=2)
    cfg = port_cfg(tmp_path, data, 1, **ON_DEVICE)
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    from robo_vln_tpu_torch.data.dataset import VLNCEDatasetV1
    from robo_vln_tpu_torch.eval.agent import HCMAgent

    agent = HCMAgent(trainer.high, trainer.low)
    B, H = 2, cfg.MODEL.STATE_ENCODER.hidden_size
    rollout = ondevice.Rollout(agent.step, cfg, B, agent.initial_state(B), "cpu")
    ws = rollout.workspace
    assert ws.dtype == torch.int64 and ws.numel() == fused_lstm.workspace_words(B, H)
    assert not ws.any()
    used = []
    plain = fused_lstm.fused_lstm_sequence

    def lstm(gates_x, masks, h0, c0, w_hh):
        used.append(fused_lstm._workspace(gates_x.device, None, gates_x.shape[1],
                                          gates_x.shape[2] // 4))
        return plain(gates_x, masks, h0, c0, w_hh)

    monkeypatch.setattr(fused_lstm, "fused_lstm_sequence", lstm)
    monkeypatch.setattr(fused_lstm, "_workspaces", {})
    episodes = VLNCEDatasetV1(config=cfg.TASK_CONFIG.DATASET).episodes
    ids = np.ones((B, 12), np.int32)
    rollout.load(ondevice.pack_episodes(episodes, 4), ids,
                 agent.embed_instruction(torch.from_numpy(ids)))
    rollout.run()
    assert used and all(w is ws for w in used)  # every launch of the run, both levels'
    # a launch outside the run grows the shared workspace; the private one stays
    shared = fused_lstm._workspace(torch.device("cpu"), None, 1, 4 * B * H)
    grown = fused_lstm._workspace(torch.device("cpu"), None, 1, 16 * B * H)
    assert grown is not shared and grown is not ws
    assert fused_lstm._workspaces[None][0] is grown
    assert rollout.workspace is ws and ws.numel() == fused_lstm.workspace_words(B, H)
    with fused_lstm.private_workspace(ws):
        assert fused_lstm._workspace(torch.device("cpu"), None, B, H) is ws
        with pytest.raises(ValueError, match="private workspace"):
            fused_lstm._workspace(torch.device("cpu"), None, B, 2 * H)


def test_shuffled_instructions_reach_the_rollout(tmp_path, monkeypatch):
    """EVAL.SHUFFLE_INSTRUCTIONS: each episode is evaluated with the next
    episode's instruction in episode-id order, as the JAX package's
    on-device driver shuffles; the last batch is padded with its final
    episode."""
    data = make_episode_json(tmp_path, n_eps=3)
    loaded = []
    original = ondevice.Rollout.load

    def keep(self, packed, instruction, embedding):
        loaded.append(instruction[:, 3].tolist())  # make_episode_json's tokens: 1, 2, 3, 4 + i
        return original(self, packed, instruction, embedding)

    monkeypatch.setattr(ondevice.Rollout, "load", keep)
    for shuffle in (False, True):
        cfg = port_cfg(tmp_path / str(shuffle), data, 1, **ON_DEVICE,
                       **{"EVAL.SHUFFLE_INSTRUCTIONS": shuffle})
        with MetricsWriter(cfg.TENSORBOARD_DIR) as writer:
            evaluator.eval_hierarchical_checkpoint(HierarchicalTrainer(cfg), "", writer, 0)
    assert loaded == [[4, 5], [6, 6], [5, 6], [4, 4]]
