"""The port's closed-loop hierarchical eval (eval/evaluator.py,
BaseTrainer.eval and ``python -m robo_vln_tpu_torch.run --run-type eval``)
against the JAX package's ``eval_hierarchical_checkpoint``.

The set-up is the tiny HCM of tests/test_torch_trainer.py (``jax_config`` /
``port_config``): float32, dropout 0, synced trunks, the JAX trainer's
weights carried over by ``load_hierarchical_weights``.  The low level's
velocity head is scaled so that the agent drives about a metre in an
episode, and the task's success distance is 4 m, so that episodes end on
success at different ticks as well as at MAX_EPISODE_STEPS 12.  Three
episodes on the kinematic backend, EVAL.DUMP_TRAJECTORIES on, at NUM_ENVS 1
and 2: per episode ``success``, ``actual_success`` and the step count
equal, every continuous stat within rtol 1e-4, every step's position within
1e-4 m.  A divergence is reported at its first episode and step with its
size.

Then the port alone, as tests/test_eval.py holds the JAX package: the
batched eval, the shuffle control, an episode count beyond the dataset,
USE_CKPT_CONFIG on a port checkpoint, the checkpoint daemon, and the entry
point on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from robo_vln_tpu.eval import evaluator as jax_evaluator
from robo_vln_tpu.training.hierarchical_trainer import HierarchicalTrainer as JaxTrainer
from robo_vln_tpu.utils.logging import MetricsWriter as JaxWriter
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.eval import evaluator
from robo_vln_tpu_torch.eval.agent import HCMAgent
from robo_vln_tpu_torch.run import run_exp
from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
from robo_vln_tpu_torch.training.trainer import BaseTrainer
from robo_vln_tpu_torch.utils.logging import MetricsWriter
from robo_vln_tpu_torch.utils.weight_port import load_hierarchical_weights
from tests.test_envs import make_episode_json
from tests.test_torch_trainer import PORT_CONFIGS, jax_config, tiny_opts
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
STATS_RTOL = 1e-4
POSITION_TOL = 1e-4  # metres
SUCCESS_DISTANCE = 4.0
VELOCITY_SCALE, VELOCITY_BIAS = 20.0, -4.5  # about 4 m/s forward, turning


def eval_options(data_path, n_envs=1, **extra):
    return {
        "TPU.PRECISION": "float32", "TPU.SYNC_FROZEN_TRUNKS_ON_INIT": True,
        "MODEL.VISUAL_LING_ATTN.dropout": 0.0, "MODEL.INSTRUCTION_ENCODER.is_bert": True,
        "TASK_CONFIG.SIMULATOR.TYPE": "kinematic",
        "TASK_CONFIG.DATASET.DATA_PATH": data_path,
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 12,
        "EVAL.SPLIT": "train", "EVAL.EPISODE_COUNT": 3, "EVAL.NUM_ENVS": n_envs,
        "EVAL.DUMP_TRAJECTORIES": True, **extra,
    }


def port_cfg(tmp_path, data_path, n_envs=1, **extra):
    opts = tiny_opts(tmp_path, batch_size=1, **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "val"), **eval_options(data_path, n_envs, **extra)})
    return get_config(opts=opts)


class _Recorder:
    """Wraps a package's ``_aggregate_and_log`` to keep the per-episode stats."""

    def __init__(self, module, monkeypatch):
        self.episodes = None
        original = module._aggregate_and_log

        def record(stats_episodes, *args, **kwargs):
            self.episodes = {str(k): dict(v) for k, v in stats_episodes.items()}
            return original(stats_episodes, *args, **kwargs)

        monkeypatch.setattr(module, "_aggregate_and_log", record)


def _trajectories(log_dir):
    with open(os.path.join(log_dir, "trajectories.jsonl")) as f:
        return {row["episode_id"]: row for row in map(json.loads, f)}


def _first_divergence(port_rows, jax_rows):
    """(episode, step, metres) of the first step whose positions differ by
    more than POSITION_TOL, or None."""
    for ep in sorted(jax_rows):
        p, j = np.asarray(port_rows[ep]["locations"]), np.asarray(jax_rows[ep]["locations"])
        n = min(len(p), len(j))
        gap = np.linalg.norm(p[:n] - j[:n], axis=1)
        if n and gap.max() > POSITION_TOL:
            t = int(np.argmax(gap > POSITION_TOL))
            return ep, t, float(gap[t])
    return None


def _scaled_velocity_head(jt):
    """The JAX trainer's low level with its velocity head scaled (both
    packages get these weights), and the two levels' variables as numpy."""
    to_np = lambda tree: jax.tree.map(np.asarray, jax.device_get(tree))  # noqa: E731
    lp = to_np(jt.state.low.params)
    lp["linear"] = {"kernel": lp["linear"]["kernel"] * VELOCITY_SCALE,
                    "bias": lp["linear"]["bias"] + np.float32(VELOCITY_BIAS)}
    jt.state = jt.state._replace(low=jt.state.low._replace(params=lp))
    return (to_np({"params": jt.state.high.params, **jt._high_extra}),
            to_np({"params": lp, **jt._low_extra}))


@pytest.mark.parametrize("n_envs", [1, 2])
def test_eval_matches_jax(tmp_path, monkeypatch, n_envs):
    data = make_episode_json(tmp_path, n_eps=3)
    success = {f"TASK_CONFIG.TASK.{k}SUCCESS_DISTANCE": SUCCESS_DISTANCE
               for k in ("", "SUCCESS.", "SPL.")}
    jcfg = jax_config(tmp_path / "jax", **{
        "EVAL.VAL_LOG_DIR": str(tmp_path / "jax" / "val"),
        **eval_options(data, n_envs, **success)})
    jt = JaxTrainer(jcfg)
    jt._setup_policy()
    high_vars, low_vars = _scaled_velocity_head(jt)
    jax_rec = _Recorder(jax_evaluator, monkeypatch)
    with JaxWriter(jcfg.TENSORBOARD_DIR) as writer:
        jax_stats = jax_evaluator.eval_hierarchical_checkpoint(jt, "", writer, 0)

    pcfg = port_cfg(tmp_path / "port", data, n_envs, **success)
    pt = HierarchicalTrainer(pcfg)
    pt._setup_policy()
    load_hierarchical_weights(pt.high, pt.low, high_vars, low_vars)
    port_rec = _Recorder(evaluator, monkeypatch)
    with MetricsWriter(pcfg.TENSORBOARD_DIR) as writer:
        port_stats = evaluator.eval_hierarchical_checkpoint(pt, "", writer, 0)

    prows, jrows = _trajectories(pcfg.TENSORBOARD_DIR), _trajectories(jcfg.TENSORBOARD_DIR)
    assert prows.keys() == jrows.keys() == {"0", "1", "2"}
    diverged = _first_divergence(prows, jrows)
    assert diverged is None, (
        "positions diverge at episode %s step %d by %.3e m" % diverged)
    for ep, j in jrows.items():
        p = prows[ep]
        for k in ("success", "actual_success", "steps"):
            assert p[k] == j[k], f"episode {ep}: {k} {p[k]} against JAX {j[k]}"
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
    # the rollouts test what they should: episodes end at different ticks,
    # some on success, and the agent drove
    assert {int(r["steps"]) for r in jrows.values()} != {13}
    assert any(r["actual_success"] for r in jrows.values())
    assert jax_stats["path_length"] > 0.5
    saved = json.load(open(Path(pcfg.EVAL.VAL_LOG_DIR) / "stats_ckpt_0_train.json"))
    assert saved["ndtw"] == pytest.approx(port_stats["ndtw"])
    logged = [json.loads(line) for line in open(Path(pcfg.TENSORBOARD_DIR) / "metrics.jsonl")]
    assert {(m["tag"], m["step"]) for m in logged} >= {("eval_train_spl", 1),
                                                       ("eval_train_ndtw", 1)}


def test_batched_eval_hierarchical(tmp_path):
    """EVAL.NUM_ENVS 2 over 4 episodes, 3 evaluated: one tick over the env
    batch, BERT re-embedded whenever the stacked ids change."""
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=4), n_envs=2)
    embeds = []
    trainer = HierarchicalTrainer(cfg)
    original = HCMAgent.embed_instruction

    def counted(self, ids, host_ids=None):
        out = original(self, ids, host_ids)
        embeds.append(self.embeds)
        return out

    HCMAgent.embed_instruction = counted
    try:
        with MetricsWriter(cfg.TENSORBOARD_DIR) as writer:
            stats = evaluator.eval_hierarchical_checkpoint(trainer, "", writer, 0)
    finally:
        HCMAgent.embed_instruction = original
    assert "ndtw" in stats and 0 <= stats["ndtw"] <= 1
    assert "actual_success" in stats
    # both envs end their episodes at tick 12 together: the batch's ids
    # change once, and 4 episodes complete before the loop reads the budget
    # (as in the JAX package's batched loop)
    assert embeds[-1] == 2 and len(embeds) == 24
    assert sorted(_trajectories(cfg.TENSORBOARD_DIR)) == ["0", "1", "2", "3"]


def test_shuffle_instructions_is_a_derangement(tmp_path):
    """Every episode ends up with a DIFFERENT episode's instruction while its
    path, goals and start pose stay its own; the same rotation as the JAX
    package's."""
    from robo_vln_tpu.data.dataset import VLNCEDatasetV1 as JaxDataset
    from robo_vln_tpu_torch.data.dataset import VLNCEDatasetV1

    path = make_episode_json(tmp_path, n_eps=5)
    ds = VLNCEDatasetV1(data_path=path)
    before = {ep.episode_id: (ep.instruction.instruction_text, list(ep.reference_path),
                              list(ep.start_position)) for ep in ds.episodes}
    assert evaluator.shuffle_instructions(ds.episodes) == 5
    for ep in ds.episodes:
        text0, path0, start0 = before[ep.episode_id]
        assert ep.instruction.instruction_text != text0
        assert list(ep.reference_path) == path0 and list(ep.start_position) == start0
    assert {ep.instruction.instruction_text for ep in ds.episodes} == {
        t for t, _, _ in before.values()}
    ref = JaxDataset(data_path=path)
    jax_evaluator.shuffle_instructions(ref.episodes)
    assert [e.instruction.instruction_text for e in ds.episodes] == [
        e.instruction.instruction_text for e in ref.episodes]
    assert evaluator.shuffle_instructions(ds.episodes[:1]) == 0


def test_shuffled_eval_runs_with_the_episodes_own_metrics(tmp_path, monkeypatch):
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=3),
                   **{"EVAL.SHUFFLE_INSTRUCTIONS": True, "EVAL.EPISODE_COUNT": 2,
                      "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 4})
    counts = []
    original = evaluator.shuffle_instructions
    monkeypatch.setattr(evaluator, "shuffle_instructions",
                        lambda eps, label="eval": counts.append(original(eps, label)))
    with MetricsWriter(cfg.TENSORBOARD_DIR) as writer:
        stats = evaluator.eval_hierarchical_checkpoint(HierarchicalTrainer(cfg), "", writer, 0)
    assert counts == [3] and "spl" in stats


@pytest.mark.parametrize("n_envs", [1, 2])
def test_eval_episode_count_exceeding_dataset_terminates(tmp_path, n_envs):
    """EVAL.EPISODE_COUNT beyond the dataset evaluates each episode once and
    terminates (the id-keyed stats dict would otherwise spin forever)."""
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=2), n_envs=n_envs,
                   **{"EVAL.EPISODE_COUNT": 50,
                      "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 5})
    with MetricsWriter(cfg.TENSORBOARD_DIR) as writer:
        stats = evaluator.eval_hierarchical_checkpoint(HierarchicalTrainer(cfg), "", writer, 0)
    assert "ndtw" in stats
    assert len(_trajectories(cfg.TENSORBOARD_DIR)) == 2


def test_duplicate_breaker_stops_a_loop_of_repeats():
    breaker = evaluator._DuplicateBreaker()
    assert not any(breaker.record(False, 2) for _ in range(20))
    assert breaker.record(False, 2)
    assert not breaker.record(True, 3)


def _saved_checkpoint(tmp_path, cfg):
    """A port checkpoint of ``cfg``'s trainer, as training writes it."""
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    trainer.save_checkpoint("ckpt.0")
    return trainer, os.path.join(cfg.CHECKPOINT_FOLDER, "ckpt.0")


def test_use_ckpt_config_full_restore(tmp_path):
    """EVAL.USE_CKPT_CONFIG restores the WHOLE training config saved with a
    port checkpoint (reference robo_vln_trainer.py:1008-1011), while the
    eval invocation's settings (EVAL, DEVICE, the split overrides) stay."""
    train_cfg = get_config(opts=["DAGGER.MAX_INSTRUCTION_LEN", 77,
                                 "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", 99,
                                 "CHECKPOINT_FOLDER", str(tmp_path / "ckpts"),
                                 "DEVICE", "cuda"])
    ckpt = tmp_path / "ckpt.0"
    ckpt.mkdir()
    ckpt_lib.write_metadata(str(ckpt), {"config": train_cfg.to_dict()})
    eval_cfg = get_config(opts=["EVAL.SPLIT", "val_unseen", "EVAL.EPISODE_COUNT", 5,
                                "DEVICE", "cpu"])
    cfg = evaluator._eval_config(SimpleNamespace(config=eval_cfg), str(ckpt))
    assert cfg.DAGGER.MAX_INSTRUCTION_LEN == 77  # restored from the checkpoint
    assert cfg.TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH == 99
    assert cfg.CHECKPOINT_FOLDER == str(tmp_path / "ckpts")
    assert cfg.EVAL.SPLIT == "val_unseen" and cfg.EVAL.EPISODE_COUNT == 5  # eval side
    assert cfg.DEVICE == "cpu"
    assert cfg.TASK_CONFIG.DATASET.SPLIT == cfg.TASK_CONFIG.TASK.NDTW.SPLIT == "val_unseen"

    off = get_config(opts=["EVAL.USE_CKPT_CONFIG", False])
    assert evaluator._eval_config(SimpleNamespace(config=off), str(ckpt)) \
        .DAGGER.MAX_INSTRUCTION_LEN == 200


def test_eval_loads_port_checkpoints_and_refuses_orbax(tmp_path):
    """A port checkpoint's weights are what the eval runs; an orbax
    directory of the JAX package raises, naming the formats the port reads
    and the script that converts it; a path that does not exist leaves the weights as they are."""
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=1),
                   **{"EVAL.EPISODE_COUNT": 1, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 3})
    saver, path = _saved_checkpoint(tmp_path, cfg)
    with torch.no_grad():
        for p in saver.high.parameters():  # the evaluating trainer differs
            p.add_(1.0)
    evaluator._load_eval_weights(saver, path)
    fresh = HierarchicalTrainer(cfg)
    fresh._setup_policy()
    for (name, got), want in zip(saver.high.state_dict().items(),
                                 fresh.high.state_dict().values()):
        assert torch.equal(got, want), name
    orbax = tmp_path / "orbax_ckpt"
    (orbax / "state").mkdir(parents=True)
    with pytest.raises(ValueError, match="train_state.pt.*reference .pth.*"
                       "scripts/jax_checkpoint_to_torch.py"):
        evaluator._load_eval_weights(fresh, str(orbax))
    evaluator._load_eval_weights(fresh, str(tmp_path / "absent"))


def test_eval_reads_a_reference_pth(tmp_path):
    """A reference-layout .pth (HCM_Agent.pth: both state_dicts and a
    config) loads every weight, marks the backbones as the checkpoint's,
    and USE_CKPT_CONFIG restores its MODEL and DAGGER stanzas only."""
    cfg = port_cfg(tmp_path, make_episode_json(tmp_path, n_eps=1))
    source = HierarchicalTrainer(cfg)
    source._setup_policy()
    pth = str(tmp_path / "HCM_Agent.pth")
    torch.save({"high_level_state_dict": source.high.state_dict(),
                "low_level_state_dict": source.low.state_dict(),
                "config": {"DAGGER": {"MAX_INSTRUCTION_LEN": 77},
                           "TASK_CONFIG": {"SEED": 5}}}, pth)
    trainer = HierarchicalTrainer(cfg)
    trainer._setup_policy()
    with torch.no_grad():
        for p in trainer.low.parameters():
            p.zero_()
    evaluator._load_eval_weights(trainer, pth)
    for (name, got), want in zip(trainer.low.state_dict().items(),
                                 source.low.state_dict().values()):
        assert torch.equal(got, want), name
    assert {v["status"] for v in trainer.pretrained_backbones.values()} == {"checkpoint"}
    restored = evaluator._eval_config(trainer, pth)
    assert restored.DAGGER.MAX_INSTRUCTION_LEN == 77
    assert restored.TASK_CONFIG.SEED == cfg.TASK_CONFIG.SEED


# -- the checkpoint sweep and daemon (BaseTrainer.eval) ---------------------------

def _daemon_cfg(tmp_path, ckpt_dir, once):
    return get_config(opts=["EVAL_CKPT_PATH_DIR", str(ckpt_dir), "EVAL.ONCE", once,
                            "EVAL.POLL_INTERVAL_SEC", 0.05, "EVAL.POLL_IDLE_TIMEOUT_SEC", 1.0,
                            "TENSORBOARD_DIR", str(tmp_path / "tb")])


def _sweeper(cfg, on_eval):
    class _T(BaseTrainer):
        def __init__(self):
            self.config = cfg

        def _eval_checkpoint(self, ck, writer, checkpoint_index=0):
            on_eval(os.path.basename(ck), checkpoint_index)

    return _T()


def test_eval_daemon_picks_up_checkpoint_landing_mid_eval(tmp_path):
    """EVAL.ONCE False: the sweep keeps polling; a checkpoint saved while the
    first is evaluated is picked up, and POLL_IDLE_TIMEOUT_SEC ends it."""
    import time

    ckpt_dir = tmp_path / "ckpts"
    (ckpt_dir / "ckpt.0").mkdir(parents=True)
    seen = []

    def on_eval(name, index):
        seen.append((name, index))
        if len(seen) == 1:  # training "saves" the next epoch mid-eval
            (ckpt_dir / "ckpt.1").mkdir()

    t0 = time.time()
    _sweeper(_daemon_cfg(tmp_path, ckpt_dir, False), on_eval).eval()
    assert seen == [("ckpt.0", 0), ("ckpt.1", 1)]
    assert time.time() - t0 >= 1.0  # exited via the idle timeout


def test_eval_once_ignores_late_checkpoints(tmp_path):
    ckpt_dir = tmp_path / "ckpts"
    (ckpt_dir / "ckpt.0").mkdir(parents=True)
    seen = []

    def on_eval(name, index):
        seen.append(name)
        (ckpt_dir / f"ckpt.{len(seen)}").mkdir()

    _sweeper(_daemon_cfg(tmp_path, ckpt_dir, True), on_eval).eval()
    assert seen == ["ckpt.0"]


def test_eval_daemon_retries_failed_checkpoint(tmp_path):
    ckpt_dir = tmp_path / "ckpts"
    (ckpt_dir / "ckpt.0").mkdir(parents=True)
    calls = []

    def on_eval(name, index):
        calls.append(name)
        if len(calls) == 1:
            raise RuntimeError("checkpoint still being written")

    _sweeper(_daemon_cfg(tmp_path, ckpt_dir, False), on_eval).eval()
    assert calls == ["ckpt.0", "ckpt.0"]  # failed once, retried, succeeded


# -- the entry point ---------------------------------------------------------------

def _cli(opts):
    return [str(x) if not isinstance(x, list) else json.dumps(x) for x in opts]


def test_entry_point_evaluates_on_the_cpu(tmp_path):
    """python -m robo_vln_tpu_torch.run --run-type eval with DEVICE cpu sweeps
    a folder holding a port checkpoint on the kinematic backend and writes
    stats_ckpt_0_<split>.json."""
    data = make_episode_json(tmp_path, n_eps=2)
    extra = {"EVAL.VAL_LOG_DIR": str(tmp_path / "val"), "EVAL.EPISODE_COUNT": 2,
             "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 4,
             "EVAL_CKPT_PATH_DIR": str(tmp_path / "ckpts"),
             **{k: v for k, v in eval_options(data).items()
                if not k.startswith("EVAL.") and k != "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS"}}
    opts = tiny_opts(tmp_path, batch_size=1, **extra)
    _saved_checkpoint(tmp_path, get_config(opts=opts))
    cmd = [sys.executable, "-m", "robo_vln_tpu_torch.run", "--run-type", "eval",
           "--exp-config", str(PORT_CONFIGS / "hierarchical_cma.yaml"), *_cli(opts)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.load(open(tmp_path / "val" / "stats_ckpt_0_val_unseen.json"))
    for k in ("ndtw", "spl", "success", "actual_success", "path_length", "distance_to_goal"):
        assert np.isfinite(stats[k]), k
    assert "Episodes evaluated: 2" in proc.stderr
    assert "kinematic integrator: native" in proc.stderr


def test_eval_entry_point_needs_cuda_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opts = _cli(tiny_opts(tmp_path, batch_size=1))
    assert opts[:2] == ["DEVICE", "cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_exp(str(PORT_CONFIGS / "hierarchical_cma.yaml"), "eval", opts[2:])
    assert not (tmp_path / "tb").exists()
