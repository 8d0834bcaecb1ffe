"""Expert data collection: rollouts -> trajectory buffer (the port's own copy
of robo_vln_tpu/envs/collection.py).

Host-side equivalent of the reference `_update_dataset`
(robo_vln_trainer.py:387-503): per episode, follow the arc-length reference
path with the waypoint P-controller (envs/expert.py), step the simulator
with velocity control at 30 Hz, record (observations, prev_action, action,
stop_step) and write the msgpack'd episode to the buffer
(data/trajectory_store.py, in the format the JAX package writes).
Preserved details:

* stop_step latched when progress > 0.985 (:451-453);
* early termination when the episode ends or on success with |vel| < 0.005
  (:455);
* a NaN waypoint or state drops the whole episode (:438-440);
* flush every LMDB_COMMIT_FREQUENCY episodes (:493-497).

Expert collection runs on the host; only DAgger-mixed collection
(envs/dagger.py) steps a policy, on the trainer's device.
``NUM_PROCESSES`` > 1 fans expert rollouts out to spawned worker processes,
which import neither torch nor CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod

import numpy as np

from ..config.tree import ConfigTree
from ..data.dataset import VLNCEDatasetV1
from ..data.loader import pack_episode, write_episode
from ..data.trajectory_store import TrajectoryStore
from ..utils.logging import logger
from .env_utils import construct_env
from .expert import ContinuousPathFollower, track_waypoint
from .obs_utils import batch_obs_data_collect, make_tokenizer, transform_obs
from .velocity_control import VelocityControl

# seconds the buffer writer waits on the workers' queue before it checks
# whether any worker is still alive
QUEUE_POLL_S = 15.0


def _collection_config(config):
    """Collection runs on the collection split (reference switches
    DATASET.SPLIT to DAGGER.COLLECT_DATA_SPLIT, robo_vln_trainer.py:861-866)."""
    ccfg = config.clone().defrost()
    split = config.DAGGER.get("COLLECT_DATA_SPLIT", "") or \
        config.TASK_CONFIG.DATASET.SPLIT
    ccfg.TASK_CONFIG.DATASET.SPLIT = split
    ccfg.freeze()
    return ccfg


def _collect_episode(env, config, tokenizer, is_bert, vel_control,
                     noise_rng=None, mixer=None, beta=1.0, mix_rng=None):
    """Run ONE expert rollout; returns (obs, prev, corr, stop_steps), or None
    for a NaN-invalid trajectory (robo_vln_trainer.py:438-440).

    noise_rng (with DAGGER.COLLECT_ACTION_NOISE > 0): DART-style recovery
    collection — the EXECUTED command is gaussian-perturbed while the
    recorded label stays the expert's clean action.

    mixer + beta < 1 (DAGGER.P < 1, envs/dagger.py): per step, execute the
    current POLICY's action with probability 1-beta instead of the expert's
    (labels stay the expert's clean action either way).  The mixer is
    stepped every step so that its recurrent state tracks the executed
    history; the coin is drawn every step too; noise applies only to
    expert-sourced commands."""
    noise_std = float(config.DAGGER.COLLECT_ACTION_NOISE)
    uuid = config.TASK_CONFIG.TASK.INSTRUCTION_SENSOR_UUID
    episode_steps = []
    observations = transform_obs(env.reset(), uuid, tokenizer=tokenizer, is_bert=is_bert)
    episode = env.current_episode
    ref_path = list(episode.reference_path) + [episode.goals[0].position]
    follower = ContinuousPathFollower(env, ref_path, waypoint_threshold=0.4)
    prev_actions = np.zeros((1, 2))
    is_done = False
    steps = 0
    stop_step = 0
    stop_flag = False
    vel_control.linear_velocity = np.zeros(3)
    vel_control.angular_velocity = np.zeros(3)
    if mixer is not None:
        mixer.reset()
    while follower.progress < 1.0:
        steps += 1
        if is_done:
            break
        follower.update_waypoint()
        state = env.get_agent_state()
        if (
            np.isnan(follower.waypoint).any()
            or np.isnan(state.position).any()
            or np.isnan(state.rotation).any()
        ):
            return None
        vel, omega = track_waypoint(
            follower.waypoint, state, vel_control,
            progress=follower.progress, dt=config.DAGGER.time_step,
        )
        exec_v, exec_w = vel, omega
        from_policy = False
        if mixer is not None:
            p_v, p_w = mixer.step(observations)
            if mix_rng is not None and mix_rng.random() >= beta and \
                    np.isfinite(p_v) and np.isfinite(p_w):
                # the eval's clipping (evaluator.py): omega only
                exec_v, exec_w = p_v, float(np.clip(p_w, -1.0, 1.0))
                from_policy = True
        if noise_std > 0.0 and noise_rng is not None and not from_policy:
            n_v, n_w = noise_rng.normal(0.0, noise_std, 2)
            exec_v, exec_w = exec_v + n_v, exec_w + n_w
        if (exec_v, exec_w) != (vel, omega):
            # the executed command for this step only: the controller's
            # velocity-smoothing memory (prev linear z in vel_control) is
            # restored to the clean command after it
            vel_control.linear_velocity = np.array([0.0, 0.0, exec_v])
            vel_control.angular_velocity = np.array([0.0, exec_w, 0.0])
            observations, _, done, _ = env.step(vel_control)
            vel_control.linear_velocity = np.array([0.0, 0.0, vel])
            vel_control.angular_velocity = np.array([0.0, omega, 0.0])
        else:
            observations, _, done, _ = env.step(vel_control)
        if mixer is not None:
            mixer.set_prev(exec_v, exec_w)
        episode_over, success = done
        if follower.progress > 0.985 and not stop_flag:
            stop_step = steps
            stop_flag = True
        is_done = episode_over or (success and abs(vel) < 0.005)
        observations = transform_obs(observations, uuid, tokenizer=tokenizer, is_bert=is_bert)
        actions = np.asarray([[vel, omega]], np.float64)
        episode_steps.append((observations, prev_actions, actions, stop_step))
        prev_actions = actions

    if not episode_steps:
        return None
    traj_obs = batch_obs_data_collect([s[0] for s in episode_steps])
    return (
        traj_obs,
        np.array([s[1][0] for s in episode_steps]),
        np.array([s[2][0] for s in episode_steps]),
        [s[3] for s in episode_steps],
    )


def collect_dataset(config, features_dir: str, update_size: int = None,
                    mixer=None, beta: float = 1.0) -> int:
    """Collect ``update_size`` (default DAGGER.UPDATE_SIZE) episodes into
    ``features_dir``, appended after the episodes it holds.  Returns the
    episodes written (a NaN-invalid rollout is dropped, not retried).

    NUM_PROCESSES > 1 fans the rollouts out to spawned worker processes
    (the reference's habitat.VectorEnv role, env_utils.py:117-205): a
    simulator holds the GIL in Python code, so threads do not scale
    collection; processes do.

    mixer + beta < 1: DAgger policy-mixed rollouts (envs/dagger.py).  The
    mixer steps the trainer's live policy on its device, so this path is
    serial: workers would need the weights shipped every iteration."""
    update_size = update_size or config.DAGGER.UPDATE_SIZE
    if mixer is not None and beta < 1.0 and config.NUM_PROCESSES > 1:
        logger.warning(
            "DAgger mixed collection (DAGGER.P < 1) runs serially; ignoring "
            f"NUM_PROCESSES={config.NUM_PROCESSES} for this iteration"
        )
    elif config.NUM_PROCESSES > 1:
        return _collect_dataset_parallel(config, features_dir, update_size)
    is_bert = config.MODEL.INSTRUCTION_ENCODER.is_bert
    tokenizer = make_tokenizer(config)
    env = construct_env(_collection_config(config))
    vel_control = VelocityControl()
    collected = 0
    store = TrajectoryStore(features_dir, writable=True)
    try:
        start_id = len(store)
        # the buffer offset folded into the seeds: each DAgger iteration (and
        # each restart-grown chunk) draws fresh perturbations and mixing
        # decisions instead of replaying the first iteration's
        noise_rng = np.random.default_rng(config.TASK_CONFIG.SEED + start_id)
        # an independent stream: beta=1.0 collection is bit-identical with or
        # without a mixer attached
        mix_rng = np.random.default_rng(
            config.TASK_CONFIG.SEED + 7919 + start_id
        ) if mixer is not None else None
        for _ in range(update_size):
            ep = _collect_episode(env, config, tokenizer, is_bert, vel_control,
                                  noise_rng=noise_rng, mixer=mixer, beta=beta,
                                  mix_rng=mix_rng)
            if ep is not None:
                write_episode(store, start_id + collected, *ep)
                collected += 1
                if collected % config.DAGGER.LMDB_COMMIT_FREQUENCY == 0:
                    store.flush()
        store.flush()
    finally:
        store.close()
        env.close()
    logger.info(f"collected {collected} expert episodes -> {features_dir}")
    return collected


# ---------------------------------------------------------------------------
# process-based collection workers
# ---------------------------------------------------------------------------

def _collection_worker(config_dict, n_episodes: int, worker_idx: int,
                       num_workers: int, scenes, queue) -> None:
    """Child-process body: build THIS worker's env over a DISJOINT episode
    share — a round-robin scene split when the dataset names several scenes
    (reference construct_envs, env_utils.py:117-205), otherwise a
    round-robin slice of the kinematic backend's episodes — then roll out
    ``n_episodes`` expert episodes and ship each as packed bytes (None for
    a dropped one).  Spawned, not forked: the parent may hold CUDA and
    threads; this path imports neither torch nor CUDA and builds no
    policy."""
    config = _collection_config(ConfigTree(config_dict))
    dataset = None
    if scenes:
        config = config.clone().defrost()
        config.TASK_CONFIG.DATASET.CONTENT_SCENES = (
            scenes[worker_idx::num_workers] or scenes
        )
        config.freeze()
    elif config.TASK_CONFIG.SIMULATOR.TYPE == "kinematic":
        dataset = VLNCEDatasetV1(config=config.TASK_CONFIG.DATASET)
        dataset.episodes = dataset.episodes[worker_idx::num_workers]
    else:
        logger.warning(
            f"collection worker {worker_idx}: no scene split available for "
            f"SIMULATOR.TYPE={config.TASK_CONFIG.SIMULATOR.TYPE!r}; workers "
            "may roll out overlapping episodes — set "
            "TASK_CONFIG.DATASET.CONTENT_SCENES per process"
        )
    is_bert = config.MODEL.INSTRUCTION_ENCODER.is_bert
    tokenizer = make_tokenizer(config)
    env = construct_env(config, dataset=dataset)
    vel_control = VelocityControl()
    noise_rng = np.random.default_rng(config.TASK_CONFIG.SEED + worker_idx)
    try:
        for _ in range(n_episodes):
            ep = _collect_episode(env, config, tokenizer, is_bert, vel_control,
                                  noise_rng=noise_rng)
            queue.put(pack_episode(*ep) if ep is not None else None)
    finally:
        env.close()


def _collect_dataset_parallel(config, features_dir: str, update_size: int) -> int:
    n = int(config.NUM_PROCESSES)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue(maxsize=4 * n)
    # scene names come from the episode file itself, so the split works for
    # any backend whose dataset file is readable
    try:
        scenes = VLNCEDatasetV1.get_scenes_to_load(
            _collection_config(config).TASK_CONFIG.DATASET
        )
    except FileNotFoundError:
        scenes = []
    per = [update_size // n + (1 if i < update_size % n else 0)
           for i in range(n)]
    procs = [
        ctx.Process(
            target=_collection_worker,
            args=(config.to_dict(), per[i], i, n, scenes, queue),
            daemon=True,
        )
        for i in range(n) if per[i] > 0
    ]
    for p in procs:
        p.start()
    collected = 0
    store = TrajectoryStore(features_dir, writable=True)
    try:
        start_id = len(store)
        for _ in range(update_size):
            while True:
                try:
                    payload = queue.get(timeout=QUEUE_POLL_S)
                    break
                except queue_mod.Empty:
                    if not any(p.is_alive() for p in procs) and queue.empty():
                        raise RuntimeError(
                            "collection workers exited before delivering all "
                            f"episodes ({collected}/{update_size} written)"
                        )
            if payload is None:
                continue
            store.put(start_id + collected, payload)
            collected += 1
            if collected % config.DAGGER.LMDB_COMMIT_FREQUENCY == 0:
                store.flush()
        store.flush()
    finally:
        store.close()
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    logger.info(
        f"collected {collected} expert episodes -> {features_dir} "
        f"({len(procs)} worker processes)"
    )
    return collected
