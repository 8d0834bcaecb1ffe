"""The eval's extras end to end against the JAX package, on the CPU: the
single-env driver's videos (VIDEO_OPTION "disk", with the TOP_DOWN_MAP
measure's tile) and PLOT_ATTENTION's heatmaps, on the hierarchical eval of
tests/test_torch_eval.py and the flat eval of tests/test_torch_flat_eval.py
(float32, the JAX trainers' weights carried over, three kinematic episodes
of at most 12 steps).

Each package's videos are caught at tasks/viz.generate_video: the same
episodes, names (episode, checkpoint, SPL) and frame counts (one a step),
frames of the same size, and each frame equal to JAX's but for the render's
rounding of positions that agree within 1e-4 m (tests/test_torch_eval.py):
at least 99% of its values equal, the mean difference under 0.5 of a
level; the frames drawn from equal observations are bitwise JAX's
(tests/test_torch_viz.py).  Each mp4 reads back with its frame count and
size (even sides: the mp4v encoder drops an odd last row or column).  The heatmaps: one PNG an episode, named as JAX's, shaped (T, L)
scaled, 99% of pixels equal (the sown maps and the salience agree within
1e-5, tests/test_torch_viz.py; the salience is 1/S for every token in both
packages, so its min-max scaling to 0..255 draws rounding noise, and the
PNG check holds the names, shapes and file format more than the values).  At NUM_ENVS 2 both
extras warn and make nothing, as in JAX.
"""

import glob
import logging
import os

import cv2
import numpy as np
import pytest

from robo_vln_tpu.eval import evaluator as jax_evaluator
from robo_vln_tpu.tasks import viz as jax_viz
from robo_vln_tpu.training.hierarchical_trainer import HierarchicalTrainer as JaxTrainer
from robo_vln_tpu.utils.logging import MetricsWriter as JaxWriter
from robo_vln_tpu_torch.eval import evaluator
from robo_vln_tpu_torch.tasks import viz
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.utils.logging import MetricsWriter
from robo_vln_tpu_torch.utils.weight_port import load_hierarchical_weights
from tests.test_envs import make_episode_json
from tests.test_torch_eval import (SUCCESS_DISTANCE, _scaled_velocity_head, eval_options,
                                   port_cfg)
from tests.test_torch_flat_eval import carried_trainers
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import jax_config

MAP = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "PATH_LENGTH", "NAVIGATION_ERROR",
       "STEPS_TAKEN", "TOP_DOWN_MAP"]


def extras(tmp_path, tag, n_envs=1, plot=True):
    return {"VIDEO_OPTION": ["disk"], "VIDEO_DIR": str(tmp_path / tag / "videos"),
            "PLOT_ATTENTION": plot, "TASK_CONFIG.TASK.MEASUREMENTS": MAP,
            "TASK_CONFIG.TASK.TOP_DOWN_MAP.MAP_RESOLUTION": 60,
            **{f"TASK_CONFIG.TASK.{k}SUCCESS_DISTANCE": SUCCESS_DISTANCE
               for k in ("", "SUCCESS.", "SPL.")}}


def catch_videos(monkeypatch, module):
    videos = []
    generate = module.generate_video

    def record(option, video_dir, images, episode_id, ckpt, metrics, *args, **kwargs):
        videos.append((str(episode_id), ckpt, dict(metrics), [im.copy() for im in images]))
        return generate(option, video_dir, images, episode_id, ckpt, metrics, *args, **kwargs)

    monkeypatch.setattr(module, "generate_video", record)
    return videos


def assert_frames_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (diff == 0).mean() >= 0.99 and diff.mean() < 0.5, (what, (diff == 0).mean())


def read_mp4(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return frames


def assert_videos_match(port, jax, video_dir):
    assert [v[:3] for v in port] == [v[:3] for v in jax] and len(port) == 3
    for (ep, _, _, frames), (_, _, _, jframes) in zip(port, jax):
        assert len(frames) == len(jframes) > 0
        for t, (f, j) in enumerate(zip(frames, jframes)):
            assert_frames_close(f, j, f"episode {ep} frame {t}")
    mp4s = sorted(glob.glob(os.path.join(video_dir, "*.mp4")))
    assert len(mp4s) == 3
    for ep, _, metrics, frames in port:
        name = f"episode={ep}-ckpt=0-SPL={metrics['SPL']:.2f}.mp4"
        back = read_mp4(os.path.join(video_dir, name))
        h, w, _ = frames[0].shape  # the mp4v encoder keeps even sides
        assert len(back) == len(frames) and back[0].shape == (h - h % 2, w - w % 2, 3)


def test_hierarchical_eval_extras_match_jax(tmp_path, monkeypatch):
    data = make_episode_json(tmp_path, n_eps=3)
    jcfg = jax_config(tmp_path / "jax", **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "jax" / "val"),
        **eval_options(data, 1, **extras(tmp_path, "jax"))})
    jt = JaxTrainer(jcfg)
    jt._setup_policy()
    high_vars, low_vars = _scaled_velocity_head(jt)
    jax_videos = catch_videos(monkeypatch, jax_viz)
    with JaxWriter(jcfg.TENSORBOARD_DIR) as writer:
        jax_evaluator.eval_hierarchical_checkpoint(jt, "", writer, 0)

    pcfg = port_cfg(tmp_path / "port", data, 1, **extras(tmp_path, "port"))
    pt = HierarchicalTrainer(pcfg)
    pt._setup_policy()
    load_hierarchical_weights(pt.high, pt.low, high_vars, low_vars)
    port_videos = catch_videos(monkeypatch, viz)
    with MetricsWriter(pcfg.TENSORBOARD_DIR) as writer:
        stats = evaluator.eval_hierarchical_checkpoint(pt, "", writer, 0)
    assert "top_down_map" not in stats
    assert_videos_match(port_videos, jax_videos, pcfg.VIDEO_DIR)
    # a frame carries the map tile: wider than rgb ∥ depth
    assert port_videos[0][3][0].shape[1] > 2 * 32

    pngs = sorted(os.listdir(os.path.join(pcfg.VIDEO_DIR, "attention")))
    assert pngs == sorted(os.listdir(os.path.join(jcfg.VIDEO_DIR, "attention")))
    assert pngs == [f"attention_ep{i}_ckpt0.png" for i in range(3)]
    for name, (_, _, _, frames) in zip(pngs, port_videos):
        got = cv2.imread(os.path.join(pcfg.VIDEO_DIR, "attention", name))
        want = cv2.imread(os.path.join(jcfg.VIDEO_DIR, "attention", name))
        length = pcfg.DAGGER.MAX_INSTRUCTION_LEN
        scale = max(1, 256 // max(len(frames), length))
        assert got.shape == (len(frames) * scale, length * scale, 3)  # a row a tick
        assert (got == want).all(-1).mean() >= 0.99, name


def test_extras_warn_beyond_one_env(tmp_path, caplog):
    data = make_episode_json(tmp_path, n_eps=3)
    pcfg = port_cfg(tmp_path, data, 2, **extras(tmp_path, "port"))
    pt = HierarchicalTrainer(pcfg)
    with caplog.at_level(logging.WARNING), MetricsWriter(pcfg.TENSORBOARD_DIR) as writer:
        stats = evaluator.eval_hierarchical_checkpoint(pt, "", writer, 0)
    assert "EVAL.NUM_ENVS>1 produces no videos" in caplog.text
    assert "EVAL.NUM_ENVS>1 produces no attention heatmaps" in caplog.text
    assert not os.path.exists(pcfg.VIDEO_DIR) and "ndtw" in stats


def test_flat_eval_videos_match_jax(tmp_path, monkeypatch):
    data = make_episode_json(tmp_path, n_eps=3)
    jt, pt = carried_trainers(tmp_path, data, 1, **{
        **extras(tmp_path, "videos", plot=False), "VIDEO_DIR": str(tmp_path / "videos")})
    jax_videos = catch_videos(monkeypatch, jax_viz)
    with JaxWriter(jt.config.TENSORBOARD_DIR) as writer:
        jax_evaluator.eval_flat_checkpoint(jt, "", writer, 0)
    for path in glob.glob(str(tmp_path / "videos" / "*.mp4")):
        os.remove(path)
    port_videos = catch_videos(monkeypatch, viz)
    with MetricsWriter(pt.config.TENSORBOARD_DIR) as writer:
        evaluator.eval_flat_checkpoint(pt, "", writer, 0)
    assert_videos_match(port_videos, jax_videos, str(tmp_path / "videos"))
