"""LangNav (robo_vln_tpu_torch/data/langnav.py) and the port's convergence
study (robo_vln_tpu_torch/scripts/convergence_study.py) against the JAX
package's: for the same seeds the generated splits are JAX's, episode by
episode and file by file, word ids included; the expert reaches every goal
through the port's kinematic env; the study's pure helpers give the JAX
script's values, and its nonlearning stage writes the JAX script's rows on
the same data."""

import gzip
import importlib.util
import json
import os

import numpy as np
import pytest

from robo_vln_tpu.data import langnav as jax_langnav
from robo_vln_tpu_torch.data import langnav
from robo_vln_tpu_torch.scripts import convergence_study as cs
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _read(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)


def jax_study():
    """scripts/convergence_study.py as a module (it runs nothing on import)."""
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_study", os.path.join(REPO, "scripts", "convergence_study.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,kwargs", [
    (0, {}),
    (7, {"n_train": 10, "n_val_unseen": 5, "n_val_seen": 3}),
    (11, {"n_train": 20, "n_val_unseen": 6, "n_segments": (2, 3, 4), "lengths": (2, 3),
          "scenes": 2}),
])
def test_generated_splits_equal_jax(tmp_path, seed, kwargs):
    ours = langnav.generate_splits(str(tmp_path / "port"), seed=seed, **kwargs)
    ref = jax_langnav.generate_splits(str(tmp_path / "jax"), seed=seed, **kwargs)
    assert set(ours) == set(ref) == {"train", "val_seen", "val_unseen"}
    for split in ours:
        got, want = _read(ours[split]), _read(ref[split])
        assert len(got["episodes"]) == len(want["episodes"])
        for a, b in zip(got["episodes"], want["episodes"]):
            assert a == b
            assert a["instruction"]["instruction_tokens"] == langnav.word_ids(
                a["instruction"]["instruction_text"])
        assert got == want
        gt = ours[split].replace(f"{split}.json.gz", f"{split}_gt.json.gz")
        assert _read(gt) == _read(ref[split].replace(f"{split}.json.gz", f"{split}_gt.json.gz"))


def test_vocabulary_and_programs_equal_jax():
    assert langnav.VOCAB == jax_langnav.VOCAB
    assert langnav.WORD_TO_ID == jax_langnav.WORD_TO_ID
    for seed in range(5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        for n in (1, 2, 3, 4):
            p = langnav.sample_program(a, n)
            assert p == jax_langnav.sample_program(b, n)
            assert langnav.program_to_instruction(p) == jax_langnav.program_to_instruction(p)
            assert langnav.program_to_path(p) == jax_langnav.program_to_path(p)
            path = langnav.program_to_path(p)
            assert langnav.densify_path(path) == jax_langnav.densify_path(path)
            assert langnav.path_length(path) == jax_langnav.path_length(path)


def test_expert_reaches_goal_through_the_port_env(tmp_path):
    """The waypoint-tracking expert succeeds on every generated episode in
    the port's KinematicEnv (32 px sensors: the render does not steer)."""
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.envs.env import KinematicEnv
    from robo_vln_tpu_torch.envs.expert import ContinuousPathFollower
    from robo_vln_tpu_torch.envs.velocity_control import VelocityControl, track_waypoint_native

    paths = langnav.generate_splits(str(tmp_path), n_train=3, n_val_unseen=1, seed=11)
    opts = {"TASK_CONFIG.SIMULATOR.TYPE": "kinematic", "TASK_CONFIG.DATASET.DATA_PATH": paths["train"],
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 600,
            "TASK_CONFIG.TASK.SUCCESS_DISTANCE": 1.0,
            "TASK_CONFIG.TASK.SUCCESS.SUCCESS_DISTANCE": 1.0,
            **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": 32
               for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")}}
    cfg = get_config(opts=[x for kv in opts.items() for x in kv])
    env = KinematicEnv(cfg)
    for _ in range(3):
        env.reset()
        ep = env.current_episode
        follower = ContinuousPathFollower(env, list(ep.reference_path) + [ep.goals[0].position],
                                          0.4)
        vc = VelocityControl()
        prev, steps, done = 0.0, 0, (False, False)
        while follower.progress < 1.0 and steps < 600 and not done[0]:
            follower.update_waypoint()
            v, w = track_waypoint_native(env.get_agent_state(), follower.waypoint, prev,
                                         follower.progress, 1 / 30)
            vc.linear_velocity = np.array([0.0, 0.0, v])
            vc.angular_velocity = np.array([0.0, w, 0.0])
            _, _, done, _ = env.step(vc)
            prev = v
            steps += 1
            if done[1] and abs(v) < 0.005:
                break
        metrics = env.get_metrics()
        assert metrics["success"] == 1.0, ep.instruction.instruction_text
        assert metrics["spl"] > 0.9


def test_study_helpers_equal_jax(monkeypatch):
    ref = jax_study()
    for mod in (cs, ref):
        monkeypatch.setattr(mod, "EPOCHS_PER_ITER", 10)
        monkeypatch.setattr(mod, "EVAL_EVERY", 4)
    for name in ("ckpt.10", "ckpt.19", "ckpt.weird", "ckpt.3"):
        assert cs.idx_of(name) == ref.idx_of(name)
    for n in (0, 1, 4, 10, 13):
        names = [f"ckpt.{10 + e}" for e in range(n)]
        assert cs.pick_checkpoints(list(names)) == ref.pick_checkpoints(list(names))
    rows = [
        {"split": "val_seen", "epoch": 4, "success": 0.5, "spl": 0.4, "ndtw": 0.6,
         "navigation_error": 2.0, "path_length": 8.0},
        {"model": "cma", "split": "val_unseen", "epoch": 0, "success": 0.0, "spl": 0.0},
        {"split": "val_seen", "epoch": 0, "success": 0.0, "spl": 0.0, "ndtw": 0.1,
         "navigation_error": 9.0, "path_length": 16.0},
    ]
    assert cs.render_table(rows) == ref.render_table(rows)
    assert (cs.MODELS.keys(), cs.EPOCHS, cs.N_TRAIN, cs.N_VAL, cs.SEGMENTS, cs.LENGTHS,
            cs.NOISE, cs.INSTR_LEN) == (ref.MODELS.keys(), ref.EPOCHS, ref.N_TRAIN, ref.N_VAL,
                                       ref.SEGMENTS, ref.LENGTHS, ref.NOISE, ref.INSTR_LEN)


@pytest.mark.parametrize("agent", ["ExpertAgent", "RandomAgent"])
def test_nonlearning_stage_rows_equal_jax(tmp_path, monkeypatch, agent):
    """Both scripts' nonlearning stage over the same two val_unseen LangNav
    episodes (32 px sensors) write the same row."""
    ref = jax_study()
    for name, mod in (("port", cs), ("jax", ref)):
        out = str(tmp_path / name)
        langnav.generate_splits(os.path.join(out, "datasets"), n_train=3, n_val_unseen=2,
                                n_val_seen=2, seed=5)
        monkeypatch.setattr(mod, "OUT", out)
        monkeypatch.setattr(mod, "N_VAL", 2)
        monkeypatch.setattr(mod, "RGB", 32)
        monkeypatch.setattr(mod, "DEPTH", 32)
        monkeypatch.setattr(mod, "MAX_STEPS", 400)
    monkeypatch.chdir(REPO)  # the JAX config names its task yaml from the repo's root
    cs.stage_nonlearning("val_unseen", agent)
    monkeypatch.setenv("CS_SPLIT", "val_unseen")
    monkeypatch.setenv("CS_AGENT", agent)
    ref.stage_nonlearning()
    rows = {}
    for name in ("port", "jax"):
        with open(tmp_path / name / "convergence_nonlearning.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    assert len(rows["port"]) == 1 and rows["port"][0].keys() == rows["jax"][0].keys()
    for key, want in rows["jax"][0].items():
        got = rows["port"][0][key]
        assert got == pytest.approx(want, abs=1e-4) if isinstance(want, float) else got == want
    if agent == "ExpertAgent":
        assert rows["port"][0]["success"] == 1.0


def test_study_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    """The port's study at tiny widths on the CPU (4 train and 2 val
    episodes, one epoch, 60 ticks, 32 px): every stage runs in this
    process; scripts/collect_study_results.py and scripts/eval_parity.py
    read its rows and traces unchanged; probe_policy replays the recorded
    episodes through the final checkpoint."""
    import subprocess
    import sys

    from robo_vln_tpu_torch.scripts import probe_policy
    from tests.test_torch_trainer import TINY_MODEL

    knobs = {"N_TRAIN": 4, "N_VAL": 2, "EPOCHS": 1, "EPOCHS_PER_ITER": 1, "TOTAL_EPOCHS": 1,
             "MAX_STEPS": 60, "DEVICE": "cpu", "NUM_ENVS": 2, "HOST_EPISODES": 1, "BATCH": 2,
             "RGB": 32, "DEPTH": 32}
    for k, v in knobs.items():
        monkeypatch.setattr(cs, k, v)
    build = cs.build_config

    def tiny(data_dir):  # LangNav's word ids run past 100: a vocabulary of 200
        cfg = build(data_dir).clone().defrost()
        for key, value in {**TINY_MODEL, "BERT.vocab_size": 200}.items():
            node = cfg.MODEL
            *path, leaf = key.split(".")
            for p in path:
                node = node[p]
            node[leaf] = value
        cfg.freeze()
        return cfg

    monkeypatch.setattr(cs, "build_config", tiny)
    out = str(tmp_path / "study")
    cs.main([out])
    rows = [json.loads(line) for line in open(os.path.join(out, "convergence.jsonl"))]
    assert {r["split"] for r in rows} == {"val_seen", "val_unseen", "val_unseen_shuffled",
                                         "val_unseen_host"}
    assert [r["model"] for r in rows if r["split"] == "val_unseen"][-2:] == [
        "nonlearning_RandomAgent", "nonlearning_ExpertAgent"]
    for r in rows:
        if r["model"] == "hcm":
            assert (r["ckpt"], r["epoch"]) == ("ckpt.1", 0)
            assert {"success", "spl", "ndtw", "eval_seconds"} <= set(r)
    report = subprocess.run([sys.executable, "scripts/collect_study_results.py", out], cwd=REPO,
                            stdout=subprocess.PIPE, text=True, timeout=120)
    assert report.returncode == 0 and "Full per-epoch table" in report.stdout
    assert "host f64 driver" in report.stdout
    # one stage alone, as scripts/eval_parity.py's host pass runs it
    for key, value in {"CS_STAGE": "eval", "CS_SPLIT": "val_unseen", "CS_HOST": "1",
                       "CS_ROWS_TAG": "parity", "CS_ONLY_CKPT": "ckpt.1"}.items():
        monkeypatch.setenv(key, value)
    cs.main([out])
    (row,) = [json.loads(line) for line in open(
        os.path.join(out, "convergence_val_unseen_host_parity.jsonl"))]
    assert (row["ckpt"], row["episodes"]) == ("ckpt.1", 1)
    parity = subprocess.run(
        [sys.executable, "scripts/eval_parity.py", out, "--ckpt", "ckpt.1",
         "--host-dir", "tb_eval/val_unseen_host_parity"], cwd=REPO, stdout=subprocess.PIPE,
        text=True, timeout=120)
    assert parity.returncode == 0 and "success agreement" in parity.stdout
    monkeypatch.setattr(probe_policy, "N_EPISODES", 1)
    ((mse, hits, labelled),) = probe_policy.probe(out)
    assert np.isfinite(mse) and 0 <= hits <= labelled > 0
