"""Env construction (the port's own copy of robo_vln_tpu/envs/env_utils.py).

`construct_env` returns ONE env; `construct_envs` the list the eval steps
together through envs/async_env.AsyncEnvPool.  Backend selection
comes from TASK_CONFIG.SIMULATOR.TYPE: ``kinematic`` or ``replay``; the
``habitat`` adapter waits for ROADMAP §A item 3c.
"""

from __future__ import annotations

from typing import List

from ..data.dataset import VLNCEDatasetV1
from .env import KinematicEnv, ReplayEnv


def construct_env(config):
    sim_type = config.TASK_CONFIG.SIMULATOR.TYPE
    if sim_type == "kinematic":
        return KinematicEnv(config)
    if sim_type == "replay":
        return ReplayEnv(config, config.DAGGER.LMDB_FEATURES_DIR.format(
            split=config.TASK_CONFIG.DATASET.SPLIT
        ))
    if sim_type == "habitat":
        raise NotImplementedError(
            "SIMULATOR.TYPE habitat: the habitat-sim adapter (envs/env.HabitatEnv) is "
            "not ported yet (ROADMAP §A item 3c); use 'kinematic' or 'replay'")
    raise ValueError(f"unknown SIMULATOR.TYPE {sim_type!r}")


def construct_envs(config, num_envs: int) -> List:
    """Scene-split multi-env construction (reference construct_envs semantics:
    content scenes split round-robin across the envs).  Returns a list of
    envs; wrap with envs.async_env.AsyncEnvPool to step them together."""
    if num_envs <= 1:
        return [construct_env(config)]

    scenes = []
    if config.TASK_CONFIG.SIMULATOR.TYPE == "kinematic":
        try:
            scenes = VLNCEDatasetV1.get_scenes_to_load(config.TASK_CONFIG.DATASET)
        except FileNotFoundError:
            scenes = []
    envs = []
    for i in range(num_envs):
        sub = config.clone().defrost()
        if scenes:
            sub.TASK_CONFIG.DATASET.CONTENT_SCENES = scenes[i::num_envs] or scenes
        sub.freeze()
        envs.append(construct_env(sub))
    return envs
