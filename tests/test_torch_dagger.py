"""The port's DAgger policy-mixed collection (envs/dagger.py, the mixer's
path through envs/collection.py and the hierarchical trainer's
collect-then-train loop) against the JAX package's, on the CPU.

The set-up is the tiny HCM of tests/test_torch_trainer.py (``jax_config`` /
``tiny_opts``: 32 px frames, float32, synced trunks), its low level's
velocity head scaled as tests/test_torch_eval.py scales it so that the
policy moves the agent, the JAX trainer's weights carried over by
utils/weight_port.py, over the short episodes of
tests/test_torch_collection.py (4-12 ticks).

* Both trainers' ``train()`` with ITERATIONS 2, P 0.5 and their epochs
  replaced by recorders (the train step's parity is
  tests/test_torch_trainer.py's): iteration 0 collects the same expert
  episodes (observations bitwise), iteration 1 mixes with beta 0.5 and
  makes the same coin decisions at every tick, every position within
  1e-4 m.
* beta 1 with a mixer attached is bitwise pure expert; beta 0 executes the
  policy at every tick while the labels stay the expert's; the mixer runs
  without dropout and gives the trainer back its train mode.
* Collect then train in one run (the port's real epochs): the buffer
  grows to 2 x UPDATE_SIZE, one checkpoint an epoch; LOAD_FROM_CKPT mixes
  from the checkpoint's weights at beta P.
"""

import os

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.envs import dagger as jax_dagger
from robo_vln_tpu.training.hierarchical_trainer import HierarchicalTrainer as JaxTrainer
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.envs import collection, dagger
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.utils.weight_port import load_hierarchical_weights
from tests.test_torch_collection import (
    MAX_STEPS,
    assert_episodes_equal,
    collect_opts,
    episode_json,
    read_buffer,
)
from tests.test_torch_eval import _scaled_velocity_head
from tests.test_torch_trainer import jax_config

POSITION_TOL = 1e-4  # metres


def _opts(tmp_path, **extra):
    """The tiny HCM collecting in float32 without dropout, trunks synced."""
    return {"TPU.PRECISION": "float32", "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
            "MODEL.VISUAL_LING_ATTN.dropout": 0.0, "DAGGER.ITERATIONS": 2,
            "DAGGER.P": 0.5, **extra}


def port_cfg(tmp_path, **extra):
    return get_config(opts=collect_opts(tmp_path, **_opts(tmp_path, **extra)))


class _Executed:
    """Records what a mixer's rollouts executed (its set_prev calls) and what
    the policy answered (its step results)."""

    def __init__(self):
        self.executed, self.answers = [], []

    def wrap(self, mixer):
        step, set_prev = mixer.step, mixer.set_prev

        def recorded_step(obs):
            out = step(obs)
            self.answers.append(out)
            return out

        def recorded_set_prev(v, w):
            self.executed.append((v, w))
            return set_prev(v, w)

        mixer.step, mixer.set_prev = recorded_step, recorded_set_prev
        return mixer


def _record_mixers(monkeypatch, module, record):
    original = module.mixer_for_trainer
    monkeypatch.setattr(module, "mixer_for_trainer",
                        lambda trainer: record.wrap(original(trainer)))


def _no_epochs(trainer_cls, monkeypatch, seen):
    """Replace a trainer's epoch by a recorder of its number."""
    def train_epoch(self, batches, epoch, writer, train_steps):
        seen.append(epoch)
        return train_steps
    monkeypatch.setattr(trainer_cls, "train_epoch", train_epoch)


def _decisions(buffer_episodes, executed):
    """Per tick of the buffer's episodes: whether the policy's command ran
    (the executed command is not the expert's label)."""
    labels = np.concatenate([np.asarray(e[2]) for _, e in buffer_episodes])
    assert len(labels) == len(executed)
    return [tuple(ex) != tuple(lab) for ex, lab in zip(executed, labels.tolist())]


def test_mixed_collection_matches_jax(tmp_path, monkeypatch):
    update = 3
    jcfg = jax_config(tmp_path / "jax", **{
        "TASK_CONFIG.SIMULATOR.TYPE": "kinematic",
        "TASK_CONFIG.DATASET.DATA_PATH": episode_json(tmp_path),
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": MAX_STEPS,
        "MODEL.INSTRUCTION_ENCODER.is_bert": True,
        "DAGGER.PRELOAD_LMDB_FEATURES": False, "DAGGER.UPDATE_SIZE": update,
        **_opts(tmp_path)})
    weights = {}

    def jax_setup(self, *args, **kwargs):
        original_jax_setup(self, *args, **kwargs)
        weights["vars"] = _scaled_velocity_head(self)

    original_jax_setup = JaxTrainer._setup_policy
    monkeypatch.setattr(JaxTrainer, "_setup_policy", jax_setup)
    jax_seen, port_seen = [], []
    _no_epochs(JaxTrainer, monkeypatch, jax_seen)
    jax_record = _Executed()
    _record_mixers(monkeypatch, jax_dagger, jax_record)
    JaxTrainer(jcfg).train()

    def port_setup(self, *args, **kwargs):
        original_port_setup(self, *args, **kwargs)
        load_hierarchical_weights(self.high, self.low, *weights["vars"])

    original_port_setup = HierarchicalTrainer._setup_policy
    monkeypatch.setattr(HierarchicalTrainer, "_setup_policy", port_setup)
    _no_epochs(HierarchicalTrainer, monkeypatch, port_seen)
    port_record = _Executed()
    _record_mixers(monkeypatch, dagger, port_record)
    pcfg = port_cfg(tmp_path / "port", **{"DAGGER.UPDATE_SIZE": update})
    HierarchicalTrainer(pcfg).train()

    assert port_seen == jax_seen == [0, 1]  # an epoch after each collection
    got = read_buffer(pcfg.DAGGER.LMDB_FEATURES_DIR)
    from robo_vln_tpu.data import serialization as jax_serialization
    want = read_buffer(jcfg.DAGGER.LMDB_FEATURES_DIR, jax_serialization)
    assert len(got) == len(want) == 2 * update
    for i in range(update):  # iteration 0: the expert alone
        assert_episodes_equal(got[i][1], want[i][1], f"expert episode {i}")
    mixed_got, mixed_want = got[update:], want[update:]
    assert [len(e[2]) for _, e in mixed_got] == [len(e[2]) for _, e in mixed_want]
    decisions = _decisions(mixed_got, port_record.executed)
    assert decisions == _decisions(mixed_want, jax_record.executed)
    assert 0 < sum(decisions) < len(decisions)  # both sources drove
    for i, ((_, g), (_, w)) in enumerate(zip(mixed_got, mixed_want)):
        gap = np.abs(np.asarray(g[0]["globalgps"], np.float64)
                     - np.asarray(w[0]["globalgps"], np.float64)).max()
        assert gap <= POSITION_TOL, f"mixed episode {i}: positions {gap:.3e} m apart"
    # the policy moved the agent off the expert's path
    assert any(not np.array_equal(g[0]["rgb"], e[0]["rgb"][:len(g[0]["rgb"])])
               for (_, g), (_, e) in zip(mixed_got, got[:update]))


def _trainer_with_mixer(tmp_path, **extra):
    trainer = HierarchicalTrainer(port_cfg(tmp_path, **extra))
    trainer._setup_policy()
    with torch.no_grad():  # a policy that drives, as in test_mixed_collection_matches_jax
        trainer.low.linear.weight.mul_(20.0)
        trainer.low.linear.bias.add_(-4.5)
    return trainer


def test_beta_one_with_a_mixer_is_pure_expert(tmp_path):
    trainer = _trainer_with_mixer(tmp_path)
    cfg = trainer.config
    collection.collect_dataset(cfg, str(tmp_path / "expert"), update_size=2)
    mixer = dagger.mixer_for_trainer(trainer)
    record = _Executed()
    record.wrap(mixer)
    collection.collect_dataset(cfg, str(tmp_path / "beta1"), update_size=2, mixer=mixer,
                               beta=1.0)
    mixer.close()
    assert [raw for raw, _ in read_buffer(tmp_path / "beta1")] == [
        raw for raw, _ in read_buffer(tmp_path / "expert")]
    assert len(record.answers) == len(record.executed) > 0  # stepped every tick


def test_beta_zero_executes_the_policy_labels_stay_the_experts(tmp_path):
    trainer = _trainer_with_mixer(tmp_path)
    mixer = dagger.mixer_for_trainer(trainer)
    record = _Executed()
    record.wrap(mixer)
    collection.collect_dataset(trainer.config, str(tmp_path / "beta0"), update_size=2,
                               mixer=mixer, beta=0.0)
    mixer.close()
    episodes = read_buffer(tmp_path / "beta0")
    # every tick executed the policy's command, omega clipped, v not
    want = [(v, float(np.clip(w, -1.0, 1.0))) for v, w in record.answers]
    assert record.executed == want
    assert any(abs(v) > 1.0 for v, _ in want)
    labels = np.concatenate([np.asarray(e[2]) for _, e in episodes])
    assert not any(tuple(x) == tuple(y) for x, y in zip(labels.tolist(), want))
    for _, (obs, prev, corr, _) in episodes:
        corr, prev = np.asarray(corr), np.asarray(prev)
        assert corr[0, 0] == -0.5  # the expert's first command from rest, facing the path
        np.testing.assert_array_equal(prev[1:], corr[:-1])  # the label stream
        assert np.abs(corr[:, 1]).max() <= 1.0


def test_mixer_runs_without_dropout_and_restores_train_mode(tmp_path):
    trainer = HierarchicalTrainer(port_cfg(tmp_path, **{"MODEL.VISUAL_LING_ATTN.dropout": 0.5}))
    trainer._setup_policy()
    trainer.high.train()  # as a train step leaves them
    trainer.low.train()
    env = collection.construct_env(collection._collection_config(trainer.config))
    obs = collection.transform_obs(env.reset(), "instruction", is_bert=True)
    mixer = dagger.mixer_for_trainer(trainer)
    assert not trainer.high.training and not trainer.low.training
    first = mixer.step(obs)
    mixer.reset()
    assert mixer.step(obs) == first  # no dropout: the same tick twice, the same action
    assert mixer.agent.embeds == 1  # BERT cached on the host's ids
    mixer.close()
    assert trainer.high.training and trainer.low.training
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 6"):
        dagger.PolicyMixer.for_flat(trainer)


def test_collect_then_train_in_one_run(tmp_path, monkeypatch):
    """ITERATIONS 2, P 0.5: iteration 0 collects the expert's episodes and
    trains an epoch, iteration 1 mixes with the trained policy at beta 0.5
    and trains again; the buffer ends at 2 x UPDATE_SIZE, with a checkpoint
    an epoch (that a rerun collects nothing is
    tests/test_torch_collection.py::test_update_dataset_skips_what_the_buffer_holds)."""
    betas = []
    original = collection.collect_dataset

    def spy(cfg, features_dir, **kwargs):
        betas.append(kwargs["beta"])
        return original(cfg, features_dir, **kwargs)

    monkeypatch.setattr(collection, "collect_dataset", spy)
    cfg = port_cfg(tmp_path, **{"MODEL.VISUAL_LING_ATTN.dropout": 0.25})
    trainer = HierarchicalTrainer(cfg)
    trainer.train()
    assert betas == [1.0, 0.5]
    assert len(read_buffer(cfg.DAGGER.LMDB_FEATURES_DIR)) == 4
    assert [os.path.basename(c) for c in ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)] == [
        "ckpt.1", "ckpt.2"]
    assert ckpt_lib.load_metadata(os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.2"))[
        "train_steps"] == 2 + 4  # a batch of 2, then 2 batches; each 2 windows of 6
    assert trainer.high.training and trainer.low.training


def test_load_from_ckpt_mixes_from_the_checkpoint(tmp_path):
    """LOAD_FROM_CKPT counts as one prior iteration: the first collection
    already mixes, at beta P, with the checkpoint's weights."""
    saver = _trainer_with_mixer(tmp_path / "saver")
    saver.save_checkpoint("ckpt.0")
    ckpt = os.path.join(saver.config.CHECKPOINT_FOLDER, "ckpt.0")
    trainer = HierarchicalTrainer(port_cfg(tmp_path, **{"DAGGER.LOAD_FROM_CKPT": True,
                                                        "DAGGER.CKPT_TO_LOAD": ckpt}))
    mixer, beta = trainer._collection_mixer(0)
    assert beta == 0.5 and mixer is not None
    for (name, got), want in zip(trainer.low.state_dict().items(),
                                 saver.low.state_dict().values()):
        assert torch.equal(got, want), name
    mixer.close()
