"""Nonlearning agents and their closed-loop evaluation (the port's own copy
of robo_vln_tpu/agents/nonlearning.py; the reference's
nonlearning_agents.py:52-212), run by ``python -m robo_vln_tpu_torch.run
--run-type eval`` when ``EVAL.EVAL_NONLEARNING`` is set (nonlearning.yaml):

* RandomContinuousAgent — v ~ U[0,2], omega ~ U[-1,1] (:150-165);
* HandcraftedAgent — random heading then 37 forward steps (:191-212), mapped
  onto continuous control (turn at max_turn_speed for the random turn budget,
  then drive forward, then stop);
* ExpertAgent — the collection expert (envs/expert.py) through the same
  eval, the pipeline's upper bound;
* evaluate_agent — closed-loop rollout with per-episode nDTW and an aggregated
  stats json (:52-148).

The agents draw from their own generators, seeded 0 as in the JAX package,
so a run repeats the JAX package's actions and stats.  Everything runs on
the host; no policy, no device.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from typing import Dict

import numpy as np

from ..envs.env_utils import construct_env
from ..envs.expert import ContinuousPathFollower, track_waypoint
from ..envs.velocity_control import VelocityControl
from ..tasks.dtw import ndtw
from ..utils.logging import logger


class RandomContinuousAgent:
    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def reset(self, env=None):
        pass

    def act(self, env=None):
        vel = self._rng.random() * 2.0
        omega = (self._rng.random() - 0.5) * 2.0
        return (vel, omega)


class HandcraftedAgent:
    """Random heading, then ~9.25 m forward (37 x 0.25 m), then stop —
    expressed as continuous velocities at 30 Hz."""

    def __init__(self, seed: int = 0, dt: float = 1.0 / 30):
        self._rng = np.random.default_rng(seed)
        self._dt = dt
        self.reset()

    def reset(self, env=None):
        turns = int(self._rng.integers(0, int(360 / 15) + 1))
        # each reference turn is 15 deg; at max_turn_speed 1 rad/s
        self._turn_steps = int(np.ceil(turns * np.deg2rad(15) / (1.0 * self._dt)))
        # 37 forward steps x 0.25 m at 1 m/s
        self._fwd_steps = int(np.ceil(37 * 0.25 / (1.0 * self._dt)))

    def act(self, env=None):
        if self._turn_steps > 0:
            self._turn_steps -= 1
            return (0.0, 1.0)
        if self._fwd_steps > 0:
            self._fwd_steps -= 1
            return (1.0, 0.0)
        return (0.0, 0.0)


class ExpertAgent:
    """Replays the collection-time expert (ContinuousPathFollower +
    track_waypoint, envs/expert.py) through the SAME closed-loop eval as
    every learned policy: its row bounds what a perfectly imitating policy
    could score under these measures and thresholds."""

    def __init__(self, seed: int = 0, dt: float = 1.0 / 30):
        self._dt = dt
        self._follower = None
        self._vc = VelocityControl()

    def reset(self, env=None):
        if env is None:
            return
        ep = env.current_episode
        ref_path = list(ep.reference_path) + [ep.goals[0].position]
        self._follower = ContinuousPathFollower(env, ref_path, waypoint_threshold=0.4)
        self._vc.linear_velocity = np.zeros(3)
        self._vc.angular_velocity = np.zeros(3)

    def act(self, env=None):
        if env is None or self._follower is None:
            return (0.0, 0.0)
        self._follower.update_waypoint()
        vel, omega = track_waypoint(
            self._follower.waypoint, env.get_agent_state(), self._vc,
            progress=self._follower.progress, dt=self._dt,
        )
        # track_waypoint speaks the sim's -z-forward convention (negative =
        # forward); the eval loop negates actions[0] (reference
        # nonlearning_agents.py:99), so hand it positive-forward speed
        return (-vel, omega)


AGENTS = {
    "RandomAgent": RandomContinuousAgent,
    "HandcraftedAgent": HandcraftedAgent,
    "ExpertAgent": ExpertAgent,
}


def evaluate_agent(config) -> Dict[str, float]:
    """EVAL.NONLEARNING.AGENT over EVAL.EPISODE_COUNT episodes of
    EVAL.SPLIT; writes ``EVAL.VAL_LOG_DIR/stats_complete_<agent>_<split>.json``
    and returns the aggregated stats."""
    from ..eval.evaluator import _DuplicateBreaker, _episode_budget

    split = config.EVAL.SPLIT
    config = config.clone().defrost()
    config.TASK_CONFIG.DATASET.SPLIT = split
    config.TASK_CONFIG.TASK.NDTW.SPLIT = split
    config.TASK_CONFIG.TASK.SDTW.SPLIT = split
    config.freeze()

    name = config.EVAL.NONLEARNING.AGENT
    if name not in AGENTS:
        raise ValueError(f"EVAL.NONLEARNING.AGENT {name!r}: one of {sorted(AGENTS)}")
    env = construct_env(config)
    # the expert tracks at the control period collection uses
    # (DAGGER.time_step), not the class default 1/30
    kwargs = {"dt": config.DAGGER.time_step} if name == "ExpertAgent" else {}
    agent = AGENTS[name](**kwargs)

    gt_json = {}
    gt_path = config.TASK_CONFIG.TASK.NDTW.GT_PATH.format(split=split)
    if os.path.exists(gt_path):
        with gzip.open(gt_path, "rt") as f:
            gt_json = json.load(f)

    vc = VelocityControl()
    env.reset()
    agent.reset(env)
    steps = 0
    stats_episodes = {}
    locations = []
    sd = config.TASK_CONFIG.TASK.NDTW.SUCCESS_DISTANCE
    budget = _episode_budget(config, [env])
    breaker = _DuplicateBreaker("nonlearning eval")
    while len(stats_episodes) < budget:
        ep = env.current_episode
        actions = agent.act(env)
        vc.linear_velocity = np.array([0, 0, -actions[0]])
        vc.angular_velocity = np.array([0, actions[1], 0])
        _, _, done, info = env.step(vc)
        episode_over, success = done
        episode_success = success and (actions[0] < 0.25)
        steps += 1
        locations.append(list(env.get_agent_position()))

        if episode_over or episode_success or \
                steps == config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS:
            gt_locations = gt_json.get(str(ep.episode_id), {}).get(
                "locations", list(ep.reference_path) + [ep.goals[0].position])
            was_new = ep.episode_id not in stats_episodes
            stats = dict(info)
            stats["ndtw"] = ndtw(locations, gt_locations, sd)
            stats_episodes[ep.episode_id] = stats
            if breaker.record(was_new, len(stats_episodes)):
                break
            locations = []
            steps = 0
            env.reset()
            agent.reset(env)

    env.close()
    aggregated = {}
    for key in next(iter(stats_episodes.values())).keys():
        vals = [v[key] for v in stats_episodes.values() if v[key] is not None]
        aggregated[key] = float(np.mean(vals)) if vals else 0.0
    out_dir = config.EVAL.VAL_LOG_DIR or "."
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"stats_complete_{name}_{split}.json")
    with open(out_path, "w") as f:
        json.dump(aggregated, f, indent=4)
    logger.info(f"nonlearning eval ({name}, {split}): {aggregated}")
    return aggregated
