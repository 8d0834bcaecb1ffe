"""The port's env layer (robo_vln_tpu_torch/envs, tasks, data/dataset.py,
data/tokenizer.py, sim/) against the JAX package's, on the CPU, from numpy
seeds.

* The integrator: the port's native library (built from its own
  sim/kinematics.cc into build/sim/) against its numpy path and against the
  JAX package's integrate_rigid_state, to 1e-12.
* DTW, fastDTW and nDTW on random paths, native and Python, to 1e-12.
* The tokenizer on a vocab file written here (both backends): ids equal.
* One KinematicEnv episode per backend stepped in both packages with the
  same velocity sequence: poses to 1e-9, rgb bitwise, depth to 1e-6, every
  other observation and every measure (TASK.MEASUREMENTS, the oracle
  measures, NDTW and SDTW) to 1e-9.
* A ReplayEnv over a buffer the port's writer made, the same in both.
* AsyncEnvPool against serial stepping; what the port refuses (the
  top-down map, the habitat backend).
"""

import numpy as np
import pytest

from robo_vln_tpu.config.default import get_config as jax_get_config
from robo_vln_tpu.envs import velocity_control as jax_vc
from robo_vln_tpu.tasks import dtw as jax_dtw
from robo_vln_tpu_torch.config import get_config
from robo_vln_tpu_torch.envs import velocity_control as port_vc
from robo_vln_tpu_torch.sim import build as sim_build
from robo_vln_tpu_torch.tasks import dtw as port_dtw
from tests.test_envs import make_episode_json
from tests.test_torch_threads import one_torch_thread  # noqa: F401

POSE_TOL = 1e-9
MEASURES = ["DISTANCE_TO_GOAL", "SUCCESS", "SPL", "PATH_LENGTH", "NAVIGATION_ERROR",
            "STEPS_TAKEN", "ORACLE_NAVIGATION_ERROR", "ORACLE_SPL", "NDTW", "SDTW"]


def _rigid(rng):
    q = rng.standard_normal(4)
    return q / np.linalg.norm(q), rng.standard_normal(3), rng.standard_normal(3), \
        rng.standard_normal(3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integrator_matches_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    assert port_vc.integrator() == "native"
    assert str(port_vc._native()._name).startswith(str(sim_build.BUILD_DIR))
    for _ in range(20):
        q, p, lin, ang = _rigid(rng)
        if rng.random() < 0.2:
            ang[:] = 0.0  # the no-rotation branch
        st = port_vc.RigidState(q.copy(), p.copy())
        got = port_vc.integrate_rigid_state(st, port_vc.VelocityControl(lin, ang), 1 / 30)
        numpy_path = port_vc.integrate_rigid_state_numpy(q.copy(), p.copy(), lin, ang, 1 / 30)
        want = jax_vc.integrate_rigid_state(jax_vc.RigidState(q.copy(), p.copy()),
                                            jax_vc.VelocityControl(lin, ang), 1 / 30)
        for other in (numpy_path, want):
            np.testing.assert_allclose(got.rotation, other.rotation, rtol=0, atol=1e-12)
            np.testing.assert_allclose(got.position, other.position, rtol=0, atol=1e-12)
        # the controlling flags zero a velocity before the step
        vc = port_vc.VelocityControl(lin, ang, controlling_lin_vel=False)
        still = port_vc.integrate_rigid_state(port_vc.RigidState(q, p), vc, 1 / 30)
        np.testing.assert_array_equal(still.position, p)
    assert port_vc.heading_from_quaternion(q) == jax_vc.heading_from_quaternion(q)


@pytest.mark.parametrize("n,m,d", [(1, 1, 3), (7, 12, 3), (40, 33, 3), (25, 25, 2)])
def test_dtw_matches_jax(n, m, d):
    rng = np.random.default_rng(n * 100 + m)
    x = np.cumsum(rng.standard_normal((n, d)) * 0.3, axis=0)
    y = np.cumsum(rng.standard_normal((m, d)) * 0.3, axis=0)
    assert port_dtw._native() is not None
    for name in ("dtw", "fastdtw"):
        got = getattr(port_dtw, name)(x, y)[0]
        assert got == pytest.approx(getattr(jax_dtw, name)(x, y)[0], rel=0, abs=1e-12), name
    got = port_dtw.ndtw(x.tolist(), y.tolist(), 3.0)
    assert got == pytest.approx(jax_dtw.ndtw(x.tolist(), y.tolist(), 3.0), rel=0, abs=1e-12)
    # the Python path computes what the native one does
    saved, port_dtw._lib = port_dtw._lib, False
    try:
        python = port_dtw.fastdtw(x, y)[0]
    finally:
        port_dtw._lib = saved
    assert python == pytest.approx(port_dtw.fastdtw(x, y)[0], rel=0, abs=1e-12)


VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "walk", "forward", "turn", "left", "right",
         "the", "door", "##s", "stop", "at", ",", ".", "go", "##ing", "to", "kitchen"]


@pytest.mark.parametrize("prefer_hf", [True, False])
def test_tokenizer_matches_jax(tmp_path, prefer_hf):
    from robo_vln_tpu.data.tokenizer import InstructionTokenizer as JaxTokenizer
    from robo_vln_tpu_torch.data.tokenizer import InstructionTokenizer

    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(VOCAB) + "\n")
    texts = ["Walk forward, turn LEFT at the doors.", "go going to the kitchen", "Stop!",
             "unknownword " * 30]
    port = InstructionTokenizer(str(vocab), max_len=12, prefer_hf=prefer_hf)
    ref = JaxTokenizer(str(vocab), max_len=12, prefer_hf=prefer_hf)
    assert (port._hf is None) == (ref._hf is None) == (not prefer_hf)
    for text in texts:
        got = port.encode(text)
        assert got.dtype == np.int32 and got.shape == (12,)
        np.testing.assert_array_equal(got, ref.encode(text))
    assert port.encode(texts[0])[:4].tolist() == [2, 4, 5, 14]


def _configs(tmp_path, sim_type="kinematic", **extra):
    """The same env config in both packages: 32 px sensors, every measure."""
    data = make_episode_json(tmp_path, n_eps=3)
    opts = {"TASK_CONFIG.SIMULATOR.TYPE": sim_type, "TASK_CONFIG.DATASET.DATA_PATH": data,
            "TASK_CONFIG.DATASET.SCENES_DIR": str(tmp_path),
            "TASK_CONFIG.TASK.MEASUREMENTS": MEASURES,
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": 40,
            **{f"TASK_CONFIG.SIMULATOR.{s}_SENSOR.{d}": 32
               for s in ("RGB", "DEPTH") for d in ("WIDTH", "HEIGHT")},
            **extra}
    flat = [x for kv in opts.items() for x in kv]
    return jax_get_config(opts=flat), get_config(opts=flat)


def _velocities(seed, n):
    rng = np.random.default_rng(seed)
    return [(float(rng.uniform(-2.0, 0.3)), float(rng.uniform(-1.0, 1.0))) for _ in range(n)]


def _assert_obs_equal(got, want, where):
    assert got.keys() == want.keys(), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert g == w, (where, k)
        elif k == "rgb":
            assert g.dtype == w.dtype and np.array_equal(g, w), (where, k)
        elif k == "depth":
            assert g.dtype == w.dtype, (where, k)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{where} {k}")
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, (where, k)
            np.testing.assert_allclose(g, w, rtol=0, atol=POSE_TOL, err_msg=f"{where} {k}")


def _assert_metrics_equal(got, want, where):
    assert got.keys() == want.keys(), where
    for k, w in want.items():
        if w is None:
            assert got[k] is None, (where, k)
        else:
            assert got[k] == pytest.approx(w, rel=0, abs=POSE_TOL), (where, k)


def test_kinematic_episode_matches_jax(tmp_path):
    """Three episodes stepped in both packages with one velocity sequence,
    each to its end (MAX_EPISODE_STEPS 40): poses, observations, done
    flags and every measure at every step."""
    from robo_vln_tpu.envs.env_utils import construct_env as jax_construct
    from robo_vln_tpu_torch.envs.env_utils import construct_env

    jcfg, pcfg = _configs(tmp_path)
    jenv, penv = jax_construct(jcfg), construct_env(pcfg)
    vels = _velocities(0, 40)
    for episode in range(3):
        _assert_obs_equal(penv.reset(), jenv.reset(), f"reset {episode}")
        assert penv.current_episode.episode_id == jenv.current_episode.episode_id
        for t, (lin, ang) in enumerate(vels):
            action = np.array([0.0, 0.0, lin]), np.array([0.0, ang, 0.0])
            pobs, prew, pdone, pinfo = penv.step(port_vc.VelocityControl(*action))
            jobs, jrew, jdone, jinfo = jenv.step(jax_vc.VelocityControl(*action))
            where = f"episode {episode} step {t}"
            state_p, state_j = penv.get_agent_state(), jenv.get_agent_state()
            np.testing.assert_allclose(state_p.position, state_j.position, rtol=0,
                                       atol=POSE_TOL, err_msg=where)
            np.testing.assert_allclose(state_p.rotation, state_j.rotation, rtol=0,
                                       atol=POSE_TOL, err_msg=where)
            _assert_obs_equal(pobs, jobs, where)
            _assert_metrics_equal(pinfo, jinfo, where)
            assert (prew, pdone) == (jrew, jdone), where
            if pdone[0]:
                break
        assert pdone[0] and t == 39
    assert pinfo["path_length"] > 1.0  # the sequence moved the agent


def test_replay_episode_matches_jax(tmp_path):
    """A ReplayEnv over a buffer written by the port's own writer (msgpack
    and flat formats) serves what the JAX package's serves."""
    from robo_vln_tpu.envs.env import ReplayEnv as JaxReplayEnv
    from robo_vln_tpu_torch.data.loader import write_episode
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
    from robo_vln_tpu_torch.envs.env_utils import construct_env

    buf = tmp_path / "buf"
    rng = np.random.default_rng(5)
    with TrajectoryStore(str(buf), writable=True) as store:
        for key in range(3):
            t = int(rng.integers(6, 10))
            obs = {"rgb": rng.integers(0, 256, (t, 32, 32, 3), dtype=np.uint8),
                   "depth": rng.random((t, 32, 32, 1), dtype=np.float32).astype(np.float16),
                   "globalgps": np.cumsum(rng.standard_normal((t, 3)), axis=0),
                   "instruction": np.tile(rng.integers(1, 50, (1, 10)), (t, 1)).astype(
                       np.float64)}
            write_episode(store, key, obs, rng.standard_normal((t, 2)),
                          rng.standard_normal((t, 2)), [t - 1] * t, flat=key == 1)
    jcfg, pcfg = _configs(tmp_path, "replay", **{"DAGGER.LMDB_FEATURES_DIR": str(buf)})
    penv = construct_env(pcfg)
    jenv = JaxReplayEnv(jcfg, str(buf))
    for episode in range(4):  # wraps around to the first episode
        _assert_obs_equal(penv.reset(), jenv.reset(), f"reset {episode}")
        done = (False, False)
        while not done[0]:
            pobs, _, done, pinfo = penv.step(None)
            jobs, _, jdone, jinfo = jenv.step(None)
            _assert_obs_equal(pobs, jobs, f"episode {episode}")
            _assert_metrics_equal(pinfo, jinfo, f"episode {episode}")
            assert done == jdone
    penv.close()
    jenv.close()


def test_async_env_pool_matches_serial_stepping(tmp_path):
    from robo_vln_tpu_torch.envs.async_env import AsyncEnvPool
    from robo_vln_tpu_torch.envs.env_utils import construct_env, construct_envs

    _, pcfg = _configs(tmp_path)
    pool = AsyncEnvPool(construct_envs(pcfg, num_envs=2))
    serial = construct_envs(pcfg, num_envs=2)
    assert [e.dataset.episodes[0].episode_id for e in pool.envs] == ["0", "1"]
    for got, env in zip(pool.reset(), serial):
        _assert_obs_equal(got, env.reset(), "reset")
    for t, (lin, ang) in enumerate(_velocities(1, 12)):
        vcs = [port_vc.VelocityControl(np.array([0.0, 0.0, lin * (i + 1)]),
                                       np.array([0.0, ang, 0.0])) for i in range(2)]
        pool.async_step(vcs)
        results = pool.wait_step()
        for (pobs, _, pdone, pinfo), env, vc in zip(results, serial, vcs):
            sobs, _, sdone, sinfo = env.step(vc)
            _assert_obs_equal(pobs, sobs, f"step {t}")
            _assert_metrics_equal(pinfo, sinfo, f"step {t}")
            assert pdone == sdone
    assert [e.current_episode.episode_id for e in pool.envs] == ["0", "1"]
    obs = pool.reset_at(0)
    assert pool.envs[0].current_episode.episode_id == "2" and obs["rgb"].shape == (32, 32, 3)
    pool.close()
    construct_env(pcfg).close()


def test_obs_transforms_match_jax(tmp_path):
    from robo_vln_tpu.envs.obs_utils import batch_obs as jax_batch
    from robo_vln_tpu.envs.obs_utils import transform_obs as jax_transform
    from robo_vln_tpu_torch.envs.env_utils import construct_env
    from robo_vln_tpu_torch.envs.obs_utils import batch_obs, transform_obs

    _, pcfg = _configs(tmp_path)
    raw = construct_env(pcfg).reset()
    for is_bert in (True, False):
        got = batch_obs(transform_obs(dict(raw), "instruction", is_bert=is_bert), 12)
        want = jax_batch(jax_transform(dict(raw), "instruction", is_bert=is_bert), 12)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        # the dataset's own ids, padded into float32; images in the transfer dtypes
        assert got["instruction"].dtype == np.float32
        assert got["instruction"][0, :4].tolist() == [1, 2, 3, 4]
        assert (got["rgb"].dtype, got["depth"].dtype) == (np.uint8, np.float16)
    assert got.keys() >= {"rgb", "depth", "instruction", "progress"}
