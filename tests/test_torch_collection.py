"""The port's expert data collection (sim/kinematics.cc's waypoint
controller, envs/{velocity_control,expert,obs_utils,collection}.py,
BaseTrainer._update_dataset, the collect-only ``robo_vln_trainer`` and the
collection yamls) against the JAX package's, on the CPU.

* ``track_waypoint``: the port's native library and its numpy path against
  the JAX package's ``track_waypoint_native`` over random states and
  waypoints, to 1e-12.
* ``ContinuousPathFollower``: the same progress and waypoint sequence.
* Expert ``collect_dataset`` at 40 px over episodes of 4-12 ticks (short
  reference paths end on the stop latch, long ones at MAX_EPISODE_STEPS),
  with COLLECT_ACTION_NOISE 0 and 0.3, against the JAX package's on the same
  episode file: every observation bitwise, actions within 1e-12 (the two
  native libraries are compiled with other flags), stop steps and episode
  counts equal.
* NUM_PROCESSES 2: the same multiset of episodes as the serial buffer,
  bytes for bytes; workers that die before the target raise.
* The collect-only run under both trainer names stops after collection;
  ``_update_dataset`` skips what the buffer already holds; LOAD_FROM_CKPT
  shifts beta; the robo_vln_trainer refuses the flat feature store and the
  parallel loader before it collects.
* Both yamls load, and ``python -m robo_vln_tpu_torch.run`` on
  robovln_data_train.yaml with DEVICE cpu writes the buffer the JAX
  package's collection writes, which the JAX package's loader reads;
  without DEVICE cpu, collection asks for the card and raises without one.

The policy-mixed (DAgger) half is tests/test_torch_dagger.py.
"""

import gzip
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.data import serialization as jax_serialization
from robo_vln_tpu.envs import collection as jax_collection
from robo_vln_tpu.envs import velocity_control as jax_vc
from robo_vln_tpu.envs.expert import ContinuousPathFollower as JaxFollower
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.data import serialization
from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
from robo_vln_tpu_torch.envs import collection
from robo_vln_tpu_torch.envs import velocity_control as port_vc
from robo_vln_tpu_torch.envs.expert import ContinuousPathFollower
from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
from robo_vln_tpu_torch.utils.registry import get_trainer
from tests.test_torch_trainer import PORT_CONFIGS, tiny_opts
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
ACTION_TOL = 1e-12
HW = 40
# reference-path lengths (m): the short ones end on the stop latch in 4-11
# ticks, the longer ones at MAX_EPISODE_STEPS
PATH_LENGTHS = (0.5, 0.7, 0.9, 3.0)
MAX_STEPS = 12


def episode_json(tmp_path, lengths=PATH_LENGTHS):
    """Synthetic robo_vln_v1 episodes: a straight leg then a turn, two
    scenes, BERT-free token ids."""
    episodes = []
    for i, length in enumerate(lengths):
        a = 0.5 * length
        path = [[0.0, 0.0, 0.0], [0.0, 0.0, -a], [0.3 * a, 0.0, -1.9 * a]]
        episodes.append({
            "episode_id": str(i), "scene_id": f"scene_{i % 2}.glb",
            "start_position": path[0], "start_rotation": [0, 0, 0, 1],
            "goals": [{"position": path[-1], "radius": 3.0}], "reference_path": path,
            "instruction": {"instruction_text": f"walk ahead then turn {i}",
                            "instruction_tokens": [1, 2, 3, 4 + i]},
            "info": {"geodesic_distance": float(length)},
        })
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "episodes.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"episodes": episodes}, f)
    return str(path)


def env_opts(data_path, **extra):
    """The collection options both packages take: the kinematic backend at
    40 px over ``data_path``, BERT ids from the dataset."""
    return {"TASK_CONFIG.SIMULATOR.TYPE": "kinematic",
            "TASK_CONFIG.DATASET.DATA_PATH": data_path,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": MAX_STEPS,
            "MODEL.INSTRUCTION_ENCODER.is_bert": True,
            **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": HW
               for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")},
            **extra}


def _flat(opts):
    return [x for kv in opts.items() for x in kv]


def read_buffer(path, package=serialization):
    """Every episode of a store as (raw bytes, (obs, prev, corr, stops))."""
    with TrajectoryStore(str(path)) as store:
        raws = [store.get(i) for i in range(len(store))]
    return [(raw, package.unpackb_any(raw)) for raw in raws]


def assert_episodes_equal(got, want, where=""):
    """Observations bitwise, actions within ACTION_TOL, stop steps equal."""
    (obs, prev, corr, stops), (jobs, jprev, jcorr, jstops) = got, want
    assert obs.keys() == jobs.keys(), where
    for k in jobs:
        g, w = np.asarray(obs[k]), np.asarray(jobs[k])
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{where} {k}"
    for g, w in ((prev, jprev), (corr, jcorr)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, where
        np.testing.assert_allclose(g, w, rtol=0, atol=ACTION_TOL, err_msg=where)
    assert list(stops) == list(jstops), where


# -- the expert ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_track_waypoint_matches_jax(seed):
    rng = np.random.default_rng(seed)
    assert port_vc.integrator() == "native"
    for i in range(40):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        p, wp = rng.standard_normal(3), rng.standard_normal(3)
        if i % 8 == 0:
            wp = p.copy()  # the zero-distance branch
        prev = float(rng.uniform(-1.0, 0.2))
        progress = float(rng.choice([0.3, 0.99, rng.random()]))
        dt = float(rng.choice([1 / 30, 0.2]))
        state = port_vc.RigidState(q, p)
        want = jax_vc.track_waypoint_native(jax_vc.RigidState(q, p), wp, prev, progress, dt)
        for got in (port_vc.track_waypoint_native(state, wp, prev, progress, dt),
                    port_vc.track_waypoint_numpy(q, p, wp, prev, progress, dt)):
            np.testing.assert_allclose(got, want, rtol=0, atol=ACTION_TOL)


class _Walker:
    """A sim for the follower: a fixed path length and a scripted position."""

    def __init__(self, path):
        self.position = np.asarray(path[0], np.float64)

    def geodesic_distance(self, a, b):
        return 4.2

    def get_agent_position(self):
        return self.position


def test_path_follower_matches_jax():
    rng = np.random.default_rng(3)
    path = np.cumsum(rng.standard_normal((6, 3)), axis=0).tolist()
    walkers = _Walker(path), _Walker(path)
    port, ref = ContinuousPathFollower(walkers[0], path, 0.4), JaxFollower(walkers[1], path, 0.4)
    for t in range(200):
        for w, f in zip(walkers, (port, ref)):
            w.position = w.position + 0.3 * (f.waypoint - w.position)
            f.update_waypoint()
        assert port.progress == ref.progress, t
        np.testing.assert_array_equal(port.waypoint, ref.waypoint)
        if ref.progress >= 1.0:
            break
    assert ref.progress >= 1.0 and t > 10
    for prog in np.linspace(-0.1, 1.1, 25):
        np.testing.assert_array_equal(port.pos_at(prog), ref.pos_at(prog))


# -- expert collection ----------------------------------------------------------------

@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_expert_collection_matches_jax(tmp_path, noise):
    opts = _flat(env_opts(episode_json(tmp_path), **{"DAGGER.COLLECT_ACTION_NOISE": noise}))
    n = len(PATH_LENGTHS) + 1  # wraps around to the first episode
    assert jax_collection.collect_dataset(jax_get_config(opts=opts), str(tmp_path / "jax"),
                                          update_size=n) == n
    assert collection.collect_dataset(get_config(opts=opts), str(tmp_path / "port"),
                                      update_size=n) == n
    got, want = read_buffer(tmp_path / "port"), read_buffer(tmp_path / "jax", jax_serialization)
    assert len(got) == len(want) == n
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        assert_episodes_equal(g, w, f"episode {i}")
    lengths = [len(w[2]) for _, w in want]
    stops = [max(w[3]) for _, w in want]
    # both ends of an episode are reached: the stop latch and the step cap
    assert min(lengths) < MAX_STEPS and max(lengths) == MAX_STEPS
    assert any(stops) and not all(stops)
    labels = np.concatenate([np.asarray(w[2]) for _, w in want])
    assert labels[:, 0].min() < -0.3 and np.abs(labels[:, 1]).max() <= 1.0
    if noise:  # the executed commands drifted from the clean run's
        clean = tmp_path / "clean"
        jax_collection.collect_dataset(
            jax_get_config(opts=_flat(env_opts(episode_json(tmp_path)))), str(clean),
            update_size=n)
        assert any(not np.array_equal(np.asarray(w[0]["rgb"]), np.asarray(c[0]["rgb"]))
                   for (_, w), (_, c) in zip(want, read_buffer(clean, jax_serialization)))


def test_obs_batching_matches_jax():
    from robo_vln_tpu.envs.obs_utils import batch_obs_data_collect as jax_batch
    from robo_vln_tpu_torch.envs.obs_utils import batch_obs_data_collect

    rng = np.random.default_rng(4)
    steps = [{"rgb": rng.random((8, 8, 3)) * 255, "depth": rng.random((8, 8, 1)),
              "instruction": rng.integers(1, 50, 3 + t % 3).astype(np.float64),
              "progress": np.array([t / 5])} for t in range(5)]
    got, want = batch_obs_data_collect(steps), jax_batch(steps)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert (got["rgb"].dtype, got["depth"].dtype) == (np.uint8, np.float16)
    assert got["instruction"].shape == (5, 5)  # ragged ids padded to the longest


def test_parallel_collection_is_the_serial_multiset(tmp_path):
    """Two spawned workers, each over its own scene's episodes: the buffer
    holds the serial run's episodes bytes for bytes, in whatever order the
    workers delivered them."""
    opts = env_opts(episode_json(tmp_path))
    n = len(PATH_LENGTHS)
    assert collection.collect_dataset(get_config(opts=_flat(opts)), str(tmp_path / "serial"),
                                      update_size=n) == n
    parallel = get_config(opts=_flat({**opts, "NUM_PROCESSES": 2}))
    assert collection.collect_dataset(parallel, str(tmp_path / "parallel"),
                                      update_size=n) == n
    serial, par = read_buffer(tmp_path / "serial"), read_buffer(tmp_path / "parallel")
    assert sorted(raw for raw, _ in par) == sorted(raw for raw, _ in serial)
    # and it grows: a second call appends after the episodes it holds
    assert collection.collect_dataset(parallel, str(tmp_path / "parallel"), update_size=2) == 2
    assert len(read_buffer(tmp_path / "parallel")) == n + 2


def test_dead_workers_raise(tmp_path, monkeypatch):
    """Workers that exit before the target is met fail the collection (here
    their env cannot be built), rather than leaving a short buffer."""
    monkeypatch.setattr(collection, "QUEUE_POLL_S", 0.5)
    cfg = get_config(opts=_flat(env_opts(episode_json(tmp_path), **{
        "NUM_PROCESSES": 2, "TASK_CONFIG.SIMULATOR.TYPE": "habitat"})))
    with pytest.raises(RuntimeError, match=r"workers exited before delivering all episodes "
                                           r"\(0/3 written\)"):
        collection.collect_dataset(cfg, str(tmp_path / "buf"), update_size=3)


def test_collection_modules_load_no_torch():
    """Collection's spawned workers import envs/collection.py (and the
    parent's main module, robo_vln_tpu_torch.run from the CLI): neither
    loads torch, so no worker can touch CUDA."""
    code = ("import sys, robo_vln_tpu_torch.envs.collection, robo_vln_tpu_torch.run\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


# -- the trainers' collection -------------------------------------------------------------

def collect_opts(tmp_path, trainer="hierarchical_trainer", **extra):
    """tests/test_torch_trainer.tiny_opts collecting over episode_json at
    32 px (the tiny model's size) instead of reading a buffer."""
    return tiny_opts(tmp_path, batch_size=2, **{
        **env_opts(episode_json(tmp_path)),
        **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": 32
           for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")},
        "TRAINER_NAME": trainer, "DAGGER.PRELOAD_LMDB_FEATURES": False,
        "DAGGER.UPDATE_SIZE": 2, "DAGGER.EPISODE_LEN_BUCKETS": [MAX_STEPS],
        "DAGGER.tbptt_steps": 6, **extra})


@pytest.mark.parametrize("trainer", ["hierarchical_trainer", "robo_vln_trainer"])
def test_collect_only_stops_after_collection(tmp_path, trainer):
    cfg = get_config(opts=collect_opts(tmp_path, trainer, **{"DAGGER.COLLECT_ONLY": True}))
    t = get_trainer(trainer)(cfg)
    t.train()
    assert len(read_buffer(cfg.DAGGER.LMDB_FEATURES_DIR)) == 2
    assert getattr(t, "high", None) is None  # no policy was built
    assert not (tmp_path / "ckpts").exists() and not (tmp_path / "tb").exists()


def test_update_dataset_skips_what_the_buffer_holds(tmp_path, monkeypatch):
    """The buffer grows to (data_it+1)*UPDATE_SIZE: an iteration it already
    holds is skipped, a partial one collects only what is missing, so a
    rerun never collects an iteration twice."""
    cfg = get_config(opts=collect_opts(tmp_path, "robo_vln_trainer",
                                       **{"DAGGER.COLLECT_ONLY": True}))
    trainer = RoboVLNTrainer(cfg)
    trainer._update_dataset(0)
    calls = []
    original = collection.collect_dataset
    monkeypatch.setattr(collection, "collect_dataset",
                        lambda *a, **kw: calls.append(kw) or original(*a, **kw))
    trainer._update_dataset(0)
    assert calls == []
    trainer._update_dataset(2)
    assert [c["update_size"] for c in calls] == [4]
    assert len(read_buffer(cfg.DAGGER.LMDB_FEATURES_DIR)) == 6


@pytest.mark.parametrize("p,load,want", [(1.0, False, [1.0, 1.0, 1.0]),
                                         (0.5, False, [1.0, 0.5, 0.25]),
                                         (0.5, True, [0.5, 0.25, 0.125])])
def test_collection_beta(tmp_path, p, load, want):
    """beta = P**data_it, LOAD_FROM_CKPT counting as one prior iteration,
    as the JAX package's _collection_mixer computes it; beta 1 builds no
    mixer."""
    cfg = get_config(opts=collect_opts(tmp_path, **{"DAGGER.P": p,
                                                    "DAGGER.LOAD_FROM_CKPT": load}))
    trainer = get_trainer(cfg.TRAINER_NAME)(cfg)
    assert [trainer._collection_beta(k) for k in range(3)] == want
    if want[0] == 1.0:
        assert trainer._collection_mixer(0) == (None, 1.0)


@pytest.mark.parametrize("extra,item", [
    ({"TPU.MESH_SHAPE": [1, 2], "DAGGER.COLLECT_ONLY": True}, "§A item 7b"),
])
def test_robo_vln_trainer_refuses_the_flat_family(tmp_path, extra, item):
    """What robo_vln_trainer still refuses, before it collects anything:
    a "model" axis of the mesh (tensor parallelism), which get_config
    refuses.  The parallel loader, once refused here, trains through it
    (tests/test_torch_parallel_loader.py); its training, eval and DAgger
    collection run: tests/test_torch_flat_trainer.py; its feature store
    too: tests/test_torch_flat_features.py."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cfg = get_config(opts=collect_opts(tmp_path, "robo_vln_trainer", **extra))
        RoboVLNTrainer(cfg).train()
    assert not (tmp_path / "train_buf").exists()


# -- the yamls and the entry point ----------------------------------------------------------

def test_collection_yamls_load(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO)  # the JAX yamls name their task config from the repo root
    for name in ("robovln_data_train.yaml", "robovln_data_val.yaml"):
        port = get_config(str(PORT_CONFIGS / name))
        ref = jax_get_config(str(REPO / "robo_vln_tpu/config/configs" / name))
        assert port.TRAINER_NAME == ref.TRAINER_NAME == "robo_vln_trainer"
        for key in ("UPDATE_SIZE", "COLLECT_DATA_SPLIT", "COLLECT_ONLY",
                    "PRELOAD_LMDB_FEATURES", "LMDB_FEATURES_DIR", "P"):
            assert port.DAGGER[key] == ref.DAGGER[key], key
        assert port.TASK_CONFIG.to_dict() == ref.TASK_CONFIG.to_dict()


@pytest.mark.parametrize("yaml,extra", [
    ("robovln_data_train.yaml", {}),  # expert collection
    ("hierarchical_cma.yaml", {"DAGGER.PRELOAD_LMDB_FEATURES": False, "DAGGER.P": 0.5,
                               "DAGGER.ITERATIONS": 2}),  # collect -> train, DAgger-mixed
])
def test_collection_needs_cuda_unless_told(tmp_path, monkeypatch, yaml, extra):
    """Without DEVICE cpu both collection entry points ask for the card, and
    raise before any work when there is none."""
    from robo_vln_tpu_torch.run import run_exp

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    opts = {"DAGGER.LMDB_FEATURES_DIR": str(tmp_path / "buf"),
            "LOG_FILE": str(tmp_path / "collect.log"), **env_opts(episode_json(tmp_path)),
            **extra}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_exp(str(PORT_CONFIGS / yaml), "train",
                [str(x) if not isinstance(x, list) else json.dumps(x) for x in _flat(opts)])
    assert not (tmp_path / "buf").exists()


def test_entry_point_collects_the_jax_buffer(tmp_path, monkeypatch):
    """python -m robo_vln_tpu_torch.run on robovln_data_train.yaml, DEVICE
    cpu: the buffer of the JAX package's collection on the same episodes,
    read by the JAX package's loader."""
    monkeypatch.chdir(REPO)  # the JAX yamls name their task config from the repo root
    from robo_vln_tpu.data.loader import TrajectoryDataset as JaxDataset

    opts = {"DEVICE": "cpu", "LOG_FILE": str(tmp_path / "collect.log"),
            "DAGGER.UPDATE_SIZE": 3, "DAGGER.LMDB_FEATURES_DIR": str(tmp_path / "port"),
            **env_opts(episode_json(tmp_path))}
    cli = [str(x) if not isinstance(x, list) else json.dumps(x) for x in _flat(opts)]
    yaml = "robovln_data_train.yaml"
    cmd = [sys.executable, "-m", "robo_vln_tpu_torch.run", "--run-type", "train",
           "--exp-config", str(PORT_CONFIGS / yaml), *cli]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Data collection complete" in proc.stderr
    ref_opts = {k: v for k, v in opts.items() if k != "DEVICE"}  # the port's key
    ref_cfg = jax_get_config(str(REPO / "robo_vln_tpu/config/configs" / yaml), _flat(
        {**ref_opts, "DAGGER.LMDB_FEATURES_DIR": str(tmp_path / "jax")}))
    assert jax_collection.collect_dataset(ref_cfg, str(tmp_path / "jax")) == 3
    got, want = read_buffer(tmp_path / "port"), read_buffer(tmp_path / "jax", jax_serialization)
    assert len(got) == len(want) == 3
    for i, ((_, g), (_, w)) in enumerate(zip(got, want)):
        assert_episodes_equal(g, w, f"episode {i}")
    episodes = list(JaxDataset(str(tmp_path / "port"), batch_size=1, is_bert=True))
    assert len(episodes) == 3 and all(np.asarray(c).shape[1] == 2 for _, _, c, _ in episodes)
