"""The eval's extras against the JAX package, on the CPU: the videos'
frames, the top-down map, the attention heatmap and the salience behind it.

1. The TOP_DOWN_MAP measure (tasks/measures.TopDownMap) along a kinematic
   episode and into the next, and every frame drawn from it
   (tasks/viz: observations_to_image, topdown_map_tile,
   append_text_to_image), bitwise equal to the JAX package's on the same
   observations and infos (mirrors tests/test_viz_map.py); the viz
   functions on random inputs (a tall map, a heading) bitwise too.
2. The heatmap: viridis as a 256x3 table, bitwise cv2's COLORMAP_VIRIDIS;
   the PNG that tasks/viz writes with zlib, read back, bitwise what cv2
   writes from the same pixels, and what the JAX evaluator's
   _save_attention_plot writes from the same salience.
3. Without OpenCV, get_config refuses VIDEO_OPTION and TOP_DOWN_MAP before
   any work, naming cv2; PLOT_ATTENTION needs none.
4. PLOT_ATTENTION's sow on the tiny HCM of tests/test_torch_agent.py over
   three ticks: each sown (B, h, L, S) map within 1e-5 of the JAX
   package's intermediates, and the salience (eval/agent.HCMAgent.salience)
   within 1e-5 of the JAX evaluator's mean of them.  Every map is a softmax
   over its S visual tokens, so that mean is the mean of the maps' 1/S for
   every token, in both packages.  The kernel's 2 calls a tick stand with the sow on and off,
   and the states agree.
"""

import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robo_vln_tpu.envs.env_utils import construct_env as jax_construct_env
from robo_vln_tpu.envs.velocity_control import VelocityControl as JaxVelocityControl
from robo_vln_tpu.eval import evaluator as jax_evaluator
from robo_vln_tpu.ops import cm_attention as jax_cm
from robo_vln_tpu.tasks import viz as jax_viz
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.envs.env_utils import construct_env
from robo_vln_tpu_torch.envs.velocity_control import VelocityControl
from robo_vln_tpu_torch.ops import cm_attention, fused_attention
from robo_vln_tpu_torch.tasks import viz
from tests.test_torch_agent import B, T, _port_agent, _to_torch, jax_tiny_hcm, make_inputs
from tests.test_torch_envs import MEASURES, _configs
from tests.test_torch_threads import one_torch_thread  # noqa: F401

SALIENCE_TOL = 1e-5


def _equal(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_top_down_map_and_frames_match_jax(tmp_path):
    jcfg, pcfg = _configs(tmp_path, **{
        "TASK_CONFIG.TASK.MEASUREMENTS": MEASURES + ["TOP_DOWN_MAP"],
        "TASK_CONFIG.TASK.TOP_DOWN_MAP.MAP_RESOLUTION": 120,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 12})
    jenv, penv = jax_construct_env(jcfg), construct_env(pcfg)
    rng = np.random.default_rng(0)
    frames = 0
    for episode in range(2):
        jobs, pobs = jenv.reset(), penv.reset()
        jinfo, pinfo = jenv.habitat_env.get_metrics(), penv.get_metrics()
        for step in range(12):
            jtd, ptd = jinfo["top_down_map"], pinfo["top_down_map"]
            _equal(ptd["map"], jtd["map"], f"map {episode}/{step}")
            assert ptd["agent_map_coord"] == jtd["agent_map_coord"]
            assert ptd["agent_angle"] == jtd["agent_angle"] == 0.0
            _equal(viz.topdown_map_tile(pinfo, 32), jax_viz.topdown_map_tile(jinfo, 32))
            frame = viz.observations_to_image(pobs, pinfo)
            _equal(frame, jax_viz.observations_to_image(jobs, jinfo), "frame")
            text = pobs["instruction"]["text"]
            _equal(viz.append_text_to_image(frame, text),
                   jax_viz.append_text_to_image(frame, text), "text")
            frames += 1
            lin, ang = float(rng.uniform(-2.0, 0.0)), float(rng.uniform(-1.0, 1.0))
            jvc, pvc = JaxVelocityControl(), VelocityControl()
            for vc in (jvc, pvc):
                vc.linear_velocity = np.array([0.0, 0.0, lin])
                vc.angular_velocity = np.array([0.0, ang, 0.0])
            jobs, _, _, jinfo = jenv.step(jvc)
            pobs, _, _, pinfo = penv.step(pvc)
        # the agent's track is drawn in blue
        assert (pinfo["top_down_map"]["map"] == np.array([30, 60, 220])).all(-1).any()
    assert frames == 24


@pytest.mark.parametrize("shape,angle", [((60, 80), 0.5), ((90, 40), -2.0)])
def test_viz_functions_match_jax(shape, angle):
    rng = np.random.default_rng(1)
    obs = {"rgb": rng.integers(0, 255, (48, 48, 3)).astype(np.uint8),
           "depth": rng.random((40, 40, 1)).astype(np.float32)}
    base = rng.integers(0, 255, shape + (3,)).astype(np.uint8)
    info = {"top_down_map": {"map": base, "agent_map_coord": (10, 12), "agent_angle": angle}}
    _equal(viz.observations_to_image(obs, {}), jax_viz.observations_to_image(obs, {}))
    _equal(viz.observations_to_image(obs, info), jax_viz.observations_to_image(obs, info))
    _equal(viz.topdown_map_tile(info, 48), jax_viz.topdown_map_tile(info, 48))
    _equal(viz.draw_agent(base.copy(), (20, 30), angle, 5),
           jax_viz.draw_agent(base.copy(), (20, 30), angle, 5))
    assert viz.topdown_map_tile({}, 48) is None


def test_attention_heatmap_png_matches_cv2_and_jax(tmp_path):
    table = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_VIRIDIS)
    _equal(viz.VIRIDIS_BGR, table[:, 0])
    rng = np.random.default_rng(2)
    for t in (1, 7, 40):  # one tick (a constant map), a few, more than 256 // L
        salience = rng.random((t, 20)).astype(np.float32)
        img = viz.attention_heatmap(salience)
        viz.write_png(str(tmp_path / "ours.png"), img)
        cv2.imwrite(str(tmp_path / "cv2.png"), img)
        ours = cv2.imread(str(tmp_path / "ours.png"), cv2.IMREAD_UNCHANGED)
        _equal(ours, cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED))
        _equal(ours, img)

        class Episode:
            episode_id = f"e{t}"

        want = jax_evaluator._save_attention_plot(salience, Episode, str(tmp_path / "jax"), 3)
        got = viz.save_attention_plot(salience, f"e{t}", str(tmp_path / "port"), 3)
        assert got.replace("/port/", "/jax/") == want
        scale = max(1, 256 // max(t, 20))
        assert ours.shape == (t * scale, 20 * scale, 3)
        _equal(cv2.imread(got, cv2.IMREAD_UNCHANGED), cv2.imread(want, cv2.IMREAD_UNCHANGED))


def test_opencv_missing_refuses_videos_and_the_map(tmp_path, monkeypatch):
    get_config(opts=["VIDEO_OPTION", '["disk"]'])  # installed here: taken
    monkeypatch.setitem(sys.modules, "cv2", None)  # the import now fails
    with pytest.raises(ImportError, match=r"VIDEO_OPTION \['disk'\].*cv2"):
        get_config(opts=["VIDEO_OPTION", '["disk"]'])
    with pytest.raises(ImportError, match="TOP_DOWN_MAP.*cv2"):
        get_config(opts=["TASK_CONFIG.TASK.MEASUREMENTS", '["SUCCESS", "TOP_DOWN_MAP"]'])
    cfg = get_config(opts=["PLOT_ATTENTION", "True", "VIDEO_DIR", str(tmp_path)])
    path = viz.save_attention_plot(np.eye(3, 5, dtype=np.float32), 0, cfg.VIDEO_DIR, 0)
    monkeypatch.delitem(sys.modules, "cv2")
    assert cv2.imread(path).shape == (153, 255, 3)


def test_salience_matches_jax_sown_maps(monkeypatch):
    jax_mc, _, high, low, high_vars, low_vars = jax_tiny_hcm()
    from robo_vln_tpu.models import make_shared_trunk_fn as jax_trunk_fn

    trunk_fn = jax_trunk_fn(jax_mc, jnp.float32, {"batch_stats": high_vars["batch_stats"]})

    @jax.jit
    def jax_tick(obs, masks, hh):
        obs = {**obs, **trunk_fn(high_vars["params"], obs)}
        (logits, hh), inter = high.apply(high_vars, obs, hh, None, masks,
                                         mutable=["intermediates"])
        weights = jax.tree.leaves(inter["intermediates"])
        return sum(jnp.mean(w, axis=(1, 3)) for w in weights) / len(weights), hh, weights

    agent = _port_agent()
    calls, sown = [], []
    kernel = fused_attention.fused_cross_modal_attention
    monkeypatch.setattr(fused_attention, "fused_cross_modal_attention",
                        lambda *a: calls.append(a[0].shape) or kernel(*a))
    sow = cm_attention.sow
    monkeypatch.setattr(cm_attention, "sow", lambda w: sown.append(w) or sow(w))
    obs, masks = make_inputs(np.random.default_rng(5))
    emb = high.apply(high_vars, jnp.asarray(obs["instruction"]), method="embed_instruction")
    hh = high.initial_hidden(B)
    state, plain_state = agent.initial_state(B), agent.initial_state(B)
    jax_cm.set_sow_attention(True)
    try:
        for t in range(T):
            tick = {"rgb": obs["rgb"][:, t], "depth": obs["depth"][:, t],
                    "instruction": obs["instruction"]}
            want, hh, maps = jax_tick({**jax.tree.map(jnp.asarray, tick),
                                       "instruction_embedding": emb},
                                      jnp.asarray(masks[:, t]), hh)
            cm_attention.set_sow_attention(True)
            calls.clear()
            sown.clear()
            _, _, state = agent.act(_to_torch(tick), state, None, torch.from_numpy(masks[:, t]))
            assert len(calls) == 2 and len(sown) == len(maps) == 2  # rgb, then depth tokens
            for got, ref in zip(sown, maps):
                assert got.shape == ref.shape
                assert (got.shape[0], got.shape[2]) == (B, obs["instruction"].shape[1])
                np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=SALIENCE_TOL)
            assert agent.salience.shape == (B, obs["instruction"].shape[1])
            np.testing.assert_allclose(agent.salience.numpy(), np.asarray(want), rtol=0,
                                       atol=SALIENCE_TOL)
            # the reference's quirk: a softmax over S keys averaged over those keys
            flat = np.mean([1 / w.shape[-1] for w in sown])
            np.testing.assert_allclose(agent.salience.numpy(), flat, rtol=1e-5)
            cm_attention.set_sow_attention(False)
            calls.clear()
            _, _, plain_state = agent.act(_to_torch(tick), plain_state, None,
                                          torch.from_numpy(masks[:, t]))
            assert len(calls) == 2 and len(sown) == 2  # off, nothing more is sown
            for a, b in zip(state, plain_state):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    finally:
        jax_cm.set_sow_attention(False)
        cm_attention.set_sow_attention(False)


def test_tensorboard_videos_are_logged(tmp_path):
    """VIDEO_OPTION "tensorboard": generate_video hands the frames to the
    writer, whose JSON lines record the frame count, as the JAX package's
    writer does; "disk" writes the mp4 beside."""
    import json

    from robo_vln_tpu_torch.utils.logging import MetricsWriter

    frames = [np.full((20, 30, 3), i * 40, np.uint8) for i in range(5)]
    with MetricsWriter(str(tmp_path / "tb")) as writer:
        viz.generate_video(["disk", "tensorboard"], str(tmp_path / "videos"), frames, 7, 2,
                           {"SPL": 0.5}, writer, fps=30)
    rows = [json.loads(line) for line in open(tmp_path / "tb" / "metrics.jsonl")]
    assert [(r["tag"], r["video_frames"], r["step"]) for r in rows] == [("episode7", 5, 2)]
    assert (tmp_path / "videos" / "episode=7-ckpt=2-SPL=0.50.mp4").exists()
    viz.generate_video([], str(tmp_path / "none"), frames, 7, 2, {}, None)
    assert not (tmp_path / "none").exists()
