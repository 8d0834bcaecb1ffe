"""The port's flat trainer (training/trainer.RoboVLNTrainer: its epochs,
checkpoints, resume and DAgger collection, and ``python -m
robo_vln_tpu_torch.run`` on the flat yamls) against the JAX package's
RoboVLNTrainer, on the CPU.

1. One epoch and its validation, float32, the JAX trainer's weights carried
   over: Seq2Seq with SimpleCNN and the progress monitor at 36 px (the
   layers all train), 16 train and 8 eval episodes of tests/test_trainers's
   ``fill_buffer``, TBPTT windows of 4 in buckets of 4 and 8; the JAX
   trainer on the tests' 8 virtual devices at a batch of 1 a device, the
   port at DAGGER.BATCH_SIZE 8.  Every logged loss within rtol 1e-4 (as
   tests/test_torch_trainer.py's epoch); the final parameters, in units of
   DAGGER.LR, within 0.01 where the port's gradient stayed above 1e-5 at
   every step and within 2 a step elsewhere.
2. A flat checkpoint round trip is bitwise; DAGGER.RESUME with
   MAX_EPOCHS_PER_RUN 1 ends bitwise where an uninterrupted run ends
   (weights, Adam's state, counters, every logged value), with the BERT
   Seq2Seq's embedding dropout live (its masks keyed by the restored step).
3. The DAgger mixer over a flat policy answers each tick as the JAX
   package's PolicyMixer.for_flat does (within 1e-4), runs without dropout
   and gives the trainer back its train mode; collect then train in one run
   with P 0.5.
4. cma_robo.yaml, seq2seq_robo.yaml and seq2seq_robo_pm.yaml (the port's
   copies) train and evaluate through run_exp, tiny sizes from trailing
   options; ``python -m robo_vln_tpu_torch.run`` trains one on the CPU.
   A reference-layout CMANet ``.pth`` (the torch mirror of
   tests/test_checkpoint_convert.py) loads as the JAX package's converter
   reads it, gives the mirror's forward within 1e-4 and evaluates.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.envs import dagger as jax_dagger
from robo_vln_tpu.training import checkpoint as jax_ckpt
from robo_vln_tpu.training.trainer import RoboVLNTrainer as JaxFlatTrainer
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.envs import collection, dagger
from robo_vln_tpu_torch.run import run_exp
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
from robo_vln_tpu_torch.utils.weight_port import cma_state_dict, flat_state_dict, load_flat_weights
from tests.test_envs import make_episode_json
from tests.test_torch_collection import collect_opts, read_buffer
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import (GRAD_FLOOR, LOSS_RTOL, PORT_CONFIGS, REPO,
                                      RecordingWriter, _assert_bitwise, _final_state,
                                      _logged, tiny_opts)
from tests.test_trainers import fill_buffer, tiny_config

SIMPLE_PX = 36
SEQ2SEQ_PM = {"MODEL.RGB_ENCODER.cnn_type": "SimpleRGBCNN",
              "MODEL.DEPTH_ENCODER.cnn_type": "SimpleDepthCNN",
              "MODEL.PROGRESS_MONITOR.use": True, "MODEL.PROGRESS_MONITOR.alpha": 0.7,
              "TPU.PRECISION": "float32"}


def _sensors(hw):
    return {f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": hw
            for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")}


def flat_opts(tmp_path, hw=SIMPLE_PX, batch_size=8, **extra):
    return tiny_opts(tmp_path, batch_size=batch_size,
                     **{"TRAINER_NAME": "robo_vln_trainer", **_sensors(hw), **extra})


def cli(opts, drop=()):
    """tiny_opts' list as command-line strings, the keys in ``drop`` left
    to the yaml."""
    pairs = [(k, v) for k, v in zip(opts[::2], opts[1::2]) if k not in drop]
    return [str(x) if not isinstance(x, list) else json.dumps(x) for kv in pairs for x in kv]


def jax_flat_config(tmp_path, hw=SIMPLE_PX, **extra):
    cfg = tiny_config(tmp_path, trainer="robo_vln_trainer", batch_size=1, hw=hw)
    for key, value in extra.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, value)
    cfg.freeze()
    return cfg


def flat_buffers(tmp_path, hw=SIMPLE_PX, n_eps=16, n_eval=8):
    fill_buffer(str(tmp_path / "train_buf"), np.random.default_rng(0), n_eps=n_eps, hw=hw)
    fill_buffer(str(tmp_path / "eval_buf"), np.random.default_rng(1), n_eps=n_eval, hw=hw)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# -- 1. one epoch against the JAX trainer -------------------------------------------------

def test_flat_epoch_matches_jax(tmp_path):
    flat_buffers(tmp_path)
    jt = JaxFlatTrainer(jax_flat_config(tmp_path, **SEQ2SEQ_PM))
    jt._setup_policy()
    assert jt.global_batch == 8
    variables = _numpy_tree({"params": jt.state.params, **jt.extra_variables})
    jt.save_checkpoint = lambda name: None
    jwriter = RecordingWriter()
    jt.train_epoch(jt._batches(jt.features_dir, seed=0), 0, jwriter, 0)
    jt.val_epoch(jt._batches(jt.eval_dir, seed=0), 0, jwriter, 0)

    pt = RoboVLNTrainer(get_config(opts=flat_opts(tmp_path, **SEQ2SEQ_PM)))
    pt._setup_policy()
    load_flat_weights(pt.policy, variables)
    pt.save_checkpoint = lambda name: None
    named = [(n, p) for g in pt.state.optimizer.param_groups for p in g["params"]
             for n, q in pt.policy.named_parameters() if q is p]
    steady, step = {}, pt.train_step

    def recording_step(state, hidden, window, lr):
        out = step(state, hidden, window, lr)
        for n, p in named:
            if p.grad is not None:
                steady[n] = (p.grad.abs() > GRAD_FLOOR) & steady.get(n, True)
        return out

    pt.train_step = recording_step
    pwriter = RecordingWriter()
    n_steps = pt.train_epoch(pt._batches(pt.features_dir, seed=0), 0, pwriter, 0)
    pt.val_epoch(pt._batches(pt.eval_dir, seed=0), 0, pwriter, 0)

    assert n_steps == 4 and len(pwriter.scalars) == len(jwriter.scalars) == 4 * 4 + 3 * 2 + 1
    assert {tag for tag, _, _ in pwriter.scalars} >= {"Aux Loss", "Val Loss Epoch"}
    for (ptag, pval, pstep), (jtag, jval, jstep) in zip(pwriter.scalars, jwriter.scalars):
        assert (ptag, pstep) == (jtag, jstep)
        np.testing.assert_allclose(pval, jval, rtol=LOSS_RTOL, err_msg=f"{ptag} {pstep}")

    want = flat_state_dict(_numpy_tree({"params": jt.state.params, **jt.extra_variables}))
    lr, checked = pt.config.DAGGER.LR, 0
    for name, p in named:
        if name not in want:  # progress_monitor is called here; sub_goal_linear never
            assert name.startswith("sub_goal_linear.") and name not in steady, name
            continue
        err = np.abs(p.detach().numpy() - want[name]) / lr
        assert err.max() <= 2 * n_steps, name
        mask = steady[name].numpy()
        assert (err[mask] <= 0.01).all(), name
        checked += mask.sum()
    assert checked > 0.5 * sum(p.numel() for _, p in named)


# -- 2. checkpoints and resume -------------------------------------------------------------

BERT_SEQ2SEQ = {"MODEL.INSTRUCTION_ENCODER.is_bert": True,
                "MODEL.INSTRUCTION_ENCODER.dropout_ratio": 0.25}


def test_flat_checkpoint_round_trip_is_bitwise(tmp_path):
    flat_buffers(tmp_path, hw=32, n_eps=4, n_eval=2)
    cfg = get_config(opts=flat_opts(tmp_path, hw=32, batch_size=2,
                                    **{"MODEL.CMA.use": True}))
    trainer = RoboVLNTrainer(cfg)
    trainer.train()
    (path,) = ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)
    assert os.path.basename(path) == "ckpt.1"
    meta = ckpt_lib.load_metadata(path)
    assert (meta["train_steps"], meta["val_steps"]) == (trainer._train_steps, 2)
    fresh = RoboVLNTrainer(cfg)
    fresh._setup_policy(True, path)
    assert fresh.state.step == trainer.state.step == trainer._train_steps
    _assert_bitwise(fresh.policy.state_dict(), trainer.policy.state_dict())
    _assert_bitwise(fresh.state.optimizer.state_dict(), trainer.state.optimizer.state_dict())
    saved = torch.load(os.path.join(path, ckpt_lib.TRAIN_STATE), weights_only=True)
    assert {"state_dict", "optimizer", "step", "param_names"} <= set(saved)
    with pytest.raises(ValueError, match="not a hierarchical checkpoint"):
        ckpt_lib.load_checkpoint(path, None, None, None)


def test_flat_resume_matches_uninterrupted_run(tmp_path):
    flat_buffers(tmp_path, hw=32, n_eps=4, n_eval=2)

    def cfg(run, **extra):
        return get_config(opts=flat_opts(tmp_path, hw=32, batch_size=2, **BERT_SEQ2SEQ, **{
            "DAGGER.EPOCHS": 2, "CHECKPOINT_FOLDER": str(tmp_path / run / "ckpts"),
            "TENSORBOARD_DIR": str(tmp_path / run / "tb"), **extra}))

    a = cfg("a")
    RoboVLNTrainer(a).train()
    b = cfg("b", **{"DAGGER.RESUME": True, "DAGGER.MAX_EPOCHS_PER_RUN": 1})
    RoboVLNTrainer(b).train()
    assert [os.path.basename(c) for c in ckpt_lib.list_checkpoints(b.CHECKPOINT_FOLDER)] == [
        "ckpt.2"]
    RoboVLNTrainer(b).train()
    state_a, meta_a = _final_state(a.CHECKPOINT_FOLDER)
    state_b, meta_b = _final_state(b.CHECKPOINT_FOLDER)
    _assert_bitwise(state_b, state_a)
    assert meta_b == meta_a and meta_a["val_steps"] == 4
    assert _logged(b.TENSORBOARD_DIR) == _logged(a.TENSORBOARD_DIR)


# -- 3. DAgger ------------------------------------------------------------------------------

MIXER_OPTS = {"TPU.PRECISION": "float32", "MODEL.CMA.use": True,
              "MODEL.INSTRUCTION_ENCODER.bidirectional": True}


def test_flat_mixer_matches_jax(tmp_path):
    """Both packages' flat mixers over the same observations: the port's
    env driven by the port mixer's actions, the JAX mixer fed the same
    observations and executed actions."""
    cfg = get_config(opts=collect_opts(tmp_path / "port", "robo_vln_trainer", **MIXER_OPTS))
    trainer = RoboVLNTrainer(cfg)
    trainer._setup_policy()
    trainer.policy.train()
    jcfg = jax_flat_config(tmp_path / "jax", hw=32, **{
        "MODEL.INSTRUCTION_ENCODER.is_bert": True, **MIXER_OPTS})
    jt = JaxFlatTrainer(jcfg)
    jt._setup_policy()
    load_flat_weights(trainer.policy, _numpy_tree({"params": jt.state.params,
                                                   **jt.extra_variables}))
    env = collection.construct_env(collection._collection_config(trainer.config))
    mixer = dagger.mixer_for_trainer(trainer)
    jmixer = jax_dagger.mixer_for_trainer(jt)
    assert not trainer.policy.training
    obs = collection.transform_obs(env.reset(), "instruction", is_bert=True)
    for tick in range(6):
        got, want = mixer.step(obs), jmixer.step(obs)
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=f"tick {tick}")
        mixer.set_prev(*got)
        jmixer.set_prev(*got)
        obs = collection.transform_obs(env.step(_velocity(got))[0], "instruction",
                                       is_bert=True)
    assert mixer.agent.embeds == 1  # the instruction encoded once an episode
    mixer.close()
    assert trainer.policy.training


def _velocity(action):
    from robo_vln_tpu_torch.envs.velocity_control import VelocityControl

    vc = VelocityControl()
    vc.linear_velocity = np.array([0.0, 0.0, float(action[0])])
    vc.angular_velocity = np.array([0.0, float(np.clip(action[1], -1.0, 1.0)), 0.0])
    return vc


def test_flat_collect_then_train_in_one_run(tmp_path, monkeypatch):
    """ITERATIONS 2, P 0.5: the expert's episodes and an epoch, then a
    collection mixed with the trained policy at beta 0.5 and another epoch:
    the buffer ends at 2 x UPDATE_SIZE with a checkpoint an epoch, and the
    mixer stepped the policy at every tick of the second collection."""
    cfg = get_config(opts=collect_opts(tmp_path, "robo_vln_trainer", **{
        **MIXER_OPTS, "DAGGER.ITERATIONS": 2, "DAGGER.P": 0.5}))
    steps = []
    original = dagger.PolicyMixer.step
    monkeypatch.setattr(dagger.PolicyMixer, "step",
                        lambda self, obs: steps.append(1) or original(self, obs))
    RoboVLNTrainer(cfg).train()
    episodes = read_buffer(cfg.DAGGER.LMDB_FEATURES_DIR)
    assert len(episodes) == 2 * cfg.DAGGER.UPDATE_SIZE
    ticks = sum(len(e[1][2]) for e in episodes[cfg.DAGGER.UPDATE_SIZE:])
    assert len(steps) == ticks > 0
    assert [os.path.basename(c) for c in ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)] \
        == ["ckpt.1", "ckpt.2"]


# -- 4. the yamls and the entry point --------------------------------------------------------

def _eval_opts(tmp_path, data, checkpoint):
    return ["TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8", "EVAL.SPLIT", "train",
            "EVAL.EPISODE_COUNT", "2", "EVAL_CKPT_PATH_DIR", str(checkpoint),
            "EVAL.VAL_LOG_DIR", str(tmp_path / "val")]


@pytest.mark.parametrize("yaml,hw", [("cma_robo.yaml", 32), ("seq2seq_robo.yaml", 32),
                                     ("seq2seq_robo_pm.yaml", 36)])
def test_flat_yamls_train_and_evaluate(tmp_path, yaml, hw):
    """Each flat yaml, as shipped, trains an epoch over a synthetic buffer
    and evaluates the checkpoint on the kinematic backend through run_exp;
    the pm yaml at 36 px with SimpleCNN encoders."""
    flat_buffers(tmp_path, hw=hw, n_eps=4, n_eval=2)
    extra = ({"MODEL.RGB_ENCODER.cnn_type": "SimpleRGBCNN",
              "MODEL.DEPTH_ENCODER.cnn_type": "SimpleDepthCNN"} if hw == 36 else {})
    opts = cli(flat_opts(tmp_path, hw=hw, batch_size=2, **extra), drop=("TRAINER_NAME",))
    run_exp(str(PORT_CONFIGS / yaml), "train", opts)
    (ckpt,) = ckpt_lib.list_checkpoints(tmp_path / "ckpts")
    meta = ckpt_lib.load_metadata(ckpt)
    assert meta["config"]["TRAINER_NAME"] == "robo_vln_trainer"
    assert meta["config"]["MODEL"]["CMA"]["use"] == (yaml == "cma_robo.yaml")
    assert meta["config"]["MODEL"]["PROGRESS_MONITOR"]["use"] == (yaml == "seq2seq_robo_pm.yaml")
    tags = {tag for tag, _, _ in _logged(tmp_path / "tb")}
    assert {"Total Loss", "Val Total Loss", "Val Loss Epoch"} <= tags
    data = make_episode_json(tmp_path, n_eps=2)
    run_exp(str(PORT_CONFIGS / yaml), "eval", opts + _eval_opts(tmp_path, data, ckpt))
    stats = json.load(open(tmp_path / "val" / "stats_ckpt_0_train.json"))
    assert 0 <= stats["ndtw"] <= 1 and "actual_success" in stats
    assert stats["pretrained_backbones"]["imagenet_rgb"]["status"] == (
        "not_in_model" if hw == 36 else "missing_file")


def test_entry_point_trains_the_flat_family_on_the_cpu(tmp_path):
    flat_buffers(tmp_path, hw=32, n_eps=4, n_eval=2)
    opts = cli(flat_opts(tmp_path, hw=32, batch_size=2))
    cmd = [sys.executable, "-m", "robo_vln_tpu_torch.run", "--run-type", "train",
           "--exp-config", str(PORT_CONFIGS / "cma_robo.yaml"), *opts]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (ckpt,) = ckpt_lib.list_checkpoints(tmp_path / "ckpts")
    assert ckpt_lib.load_metadata(ckpt)["config"]["DEVICE"] == "cpu"


def _mirror_cma_pth(tmp_path):
    """A reference CMANet .pth from tests/test_checkpoint_convert.py's torch
    mirror, with random BatchNorm statistics."""
    from tests.test_checkpoint_convert import TorchCMA

    torch.manual_seed(0)
    mirror = TorchCMA().eval()
    for m in mirror.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    path = str(tmp_path / "cma.pth")
    torch.save({"state_dict": mirror.state_dict(), "config": {"TRAINER_NAME": "x"}}, path)
    return path, mirror


def _mirror_opts(tmp_path):
    """The port's flat trainer at the mirror's sizes."""
    from tests.test_checkpoint_convert import H_STATE, INS_E, INS_H, OUT_D, OUT_R
    from tests.test_encoders import BLOCKS

    return flat_opts(tmp_path, hw=64, batch_size=1, **{
        "MODEL.CMA.use": True, "MODEL.INSTRUCTION_ENCODER.bidirectional": True,
        "MODEL.INSTRUCTION_ENCODER.embedding_size": INS_E,
        "MODEL.INSTRUCTION_ENCODER.hidden_size": INS_H,
        "MODEL.STATE_ENCODER.hidden_size": H_STATE, "MODEL.RGB_ENCODER.output_size": OUT_R,
        "MODEL.DEPTH_ENCODER.output_size": OUT_D, "MODEL.RGB_ENCODER.blocks": list(BLOCKS),
        "MODEL.DEPTH_ENCODER.blocks": list(BLOCKS), "TPU.PRECISION": "float32",
        **{f"TASK_CONFIG.SIMULATOR.RGB_SENSOR.{d}": 128 for d in ("WIDTH", "HEIGHT")}})


def test_reference_flat_pth_loads_runs_and_evaluates(tmp_path):
    from tests.test_encoders import BLOCKS

    path, mirror = _mirror_cma_pth(tmp_path)
    trainer = RoboVLNTrainer(get_config(opts=_mirror_opts(tmp_path)))
    trainer._setup_policy()
    n = ckpt_lib.load_reference_flat_checkpoint(trainer, path)
    sd = {k: v.numpy() for k, v in mirror.state_dict().items()}
    want = cma_state_dict(jax_ckpt.convert_cma_state_dict(sd, blocks=BLOCKS))
    got = trainer.policy.state_dict()
    assert n == len(got) and got.keys() == want.keys()
    for k, v in got.items():
        assert np.array_equal(v.numpy(), want[k]), k

    rng = np.random.default_rng(2)
    Tn = 3
    rgb = rng.integers(0, 255, (Tn, 128, 128, 3)).astype(np.float32)
    depth = rng.random((Tn, 64, 64, 1)).astype(np.float32)
    ids = rng.integers(1, 60, (1, 10))
    ids[0, 7:] = 0
    masks = np.ones(Tn, np.float32)
    masks[0] = 0.0
    with torch.no_grad():
        ref_actions, ref_stop = mirror(torch.from_numpy(rgb), torch.from_numpy(depth),
                                       torch.from_numpy(ids), torch.from_numpy(masks))
        policy = trainer.policy
        obs = {"rgb": torch.from_numpy(rgb)[None], "depth": torch.from_numpy(depth)[None],
               "instruction": torch.from_numpy(ids)}
        actions, stop, _, _ = policy(obs, policy.initial_hidden(1), None,
                                     torch.from_numpy(masks)[None])
    np.testing.assert_allclose(actions[0].numpy(), ref_actions.numpy(), atol=1e-4)
    np.testing.assert_allclose(stop[0].numpy(), ref_stop.numpy(), atol=1e-4)

    data = make_episode_json(tmp_path, n_eps=2)
    opts = cli(_mirror_opts(tmp_path))
    run_exp(str(PORT_CONFIGS / "cma_robo.yaml"), "eval", opts + _eval_opts(tmp_path, data, path))
    stats = json.load(open(tmp_path / "val" / "stats_ckpt_0_train.json"))
    assert 0 <= stats["ndtw"] <= 1
    assert stats["pretrained_backbones"]["imagenet_rgb"]["status"] == "checkpoint"
    with pytest.raises(ValueError, match="hierarchical_trainer"):
        torch.save({"high_level_state_dict": {}}, tmp_path / "hcm.pth")
        ckpt_lib.load_reference_flat_checkpoint(trainer, str(tmp_path / "hcm.pth"))
