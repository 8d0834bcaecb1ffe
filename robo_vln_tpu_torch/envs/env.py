"""Environment backends behind one interface (the port's own copy of
robo_vln_tpu/envs/env.py).

The env surface is a small protocol --

    reset() -> obs dict
    step(VelocityControl) -> (obs, reward, (episode_over, success), info)
    current_episode / get_agent_position / geodesic_distance / get_metrics

-- with three backends:

* :class:`KinematicEnv` — renderless continuous-control simulator: the native
  C++ velocity integrator (sim/kinematics.cc) steps the agent at 30 Hz over
  the episode's geometry; geodesics are arc lengths along the reference path
  (projection-based for off-path queries); observations are procedurally
  synthesized (position/heading-keyed patterns) at the task's sensor
  resolutions (224 px rgb, 256 px depth by default).  This reproduces the
  habitat-sim VelocityControl/dataset semantics end-to-end without a
  renderer — enough for metric computation and the closed-loop eval.
* :class:`ReplayEnv` — serves recorded observations from a trajectory buffer
  (data/trajectory_store.py, data/serialization.py); used for offline
  eval/metric parity and pipeline tests.
* :class:`HabitatEnv` — thin adapter over habitat-sim/habitat-lab when
  installed (imported when the env is built; the reference's simulator).

All apply the task's episode termination rules: success = geodesic
distance < SUCCESS_DISTANCE, episode_over after MAX_EPISODE_STEPS.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data import serialization
from ..data.dataset import InstructionData, NavigationGoal, VLNCEDatasetV1, VLNEpisode
from ..data.trajectory_store import TrajectoryStore
from ..tasks.measures import build_measures
from .velocity_control import (
    RigidState,
    VelocityControl,
    heading_from_quaternion,
    integrate_rigid_state,
)


def habitat_rotation_to_wxyz(rot: List[float]) -> np.ndarray:
    """habitat episodes store start_rotation as (x, y, z, w)."""
    x, y, z, w = rot
    return np.array([w, x, y, z], np.float64)


class _PolylineGeodesics:
    """Geodesic oracle over the episode's reference path: distance along the
    polyline + perpendicular offsets (the renderless stand-in for a navmesh)."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, np.float64)
        segs = self.points[1:] - self.points[:-1]
        self.seg_len = np.linalg.norm(segs, axis=1)
        self.cum = np.concatenate([[0.0], np.cumsum(self.seg_len)])
        self.total = float(self.cum[-1])

    def _project(self, p: np.ndarray) -> Tuple[float, float]:
        """(arc position of the closest polyline point, distance to it)."""
        p = np.asarray(p, np.float64)
        best = (0.0, float(np.linalg.norm(p - self.points[0])))
        for i in range(len(self.seg_len)):
            a, b = self.points[i], self.points[i + 1]
            ab = b - a
            L2 = float(np.dot(ab, ab))
            t = 0.0 if L2 == 0 else float(np.clip(np.dot(p - a, ab) / L2, 0, 1))
            proj = a + t * ab
            d = float(np.linalg.norm(p - proj))
            if d < best[1]:
                best = (float(self.cum[i] + t * self.seg_len[i]), d)
        return best

    def distance(self, a, b) -> float:
        sa, da = self._project(a)
        sb, db = self._project(b)
        return abs(sb - sa) + da + db


class _BaseEnv:
    """Shared sensor/measure plumbing."""

    def __init__(self, config):
        self.config = config
        tc = config.TASK_CONFIG
        self._max_steps = tc.ENVIRONMENT.MAX_EPISODE_STEPS
        self._success_distance = tc.TASK.SUCCESS_DISTANCE
        self._rgb_hw = (tc.SIMULATOR.RGB_SENSOR.HEIGHT, tc.SIMULATOR.RGB_SENSOR.WIDTH)
        self._depth_hw = (
            tc.SIMULATOR.DEPTH_SENSOR.HEIGHT, tc.SIMULATOR.DEPTH_SENSOR.WIDTH
        )
        self._measures: Dict = {}
        self._steps = 0
        self.current_episode: Optional[VLNEpisode] = None

    # sim protocol used by measures
    def get_agent_position(self) -> np.ndarray:
        raise NotImplementedError

    def geodesic_distance(self, a, b) -> float:
        raise NotImplementedError

    def _setup_measures(self):
        tc = self.config.TASK_CONFIG
        self._measures = build_measures(list(tc.TASK.MEASUREMENTS), self, tc.TASK)

    def _reset_measures(self):
        for m in self._measures.values():
            m.reset_metric(self.current_episode)

    def _update_measures(self, **kwargs):
        for m in self._measures.values():
            m.update_metric(self.current_episode, **kwargs)

    def get_metrics(self) -> Dict[str, float]:
        return {k: m.metric for k, m in self._measures.items()}

    def get_done(self) -> Tuple[bool, bool]:
        success = (
            self.geodesic_distance(
                self.get_agent_position(), self.current_episode.goals[0].position
            )
            < self._success_distance
        )
        return self._steps >= self._max_steps, bool(success)

    def close(self):
        pass


class KinematicEnv(_BaseEnv):
    """``dataset``: the episodes to serve (collection's workers hand each env
    a slice); by default the config's dataset file."""

    def __init__(self, config, dataset: Optional[VLNCEDatasetV1] = None):
        super().__init__(config)
        if dataset is None:
            dataset = VLNCEDatasetV1(config=config.TASK_CONFIG.DATASET)
        self.dataset = dataset
        self._ep_iter = 0
        self._state = RigidState()
        self._geo: Optional[_PolylineGeodesics] = None
        self._dt = config.DAGGER.time_step
        self._setup_measures()

    # -- sim protocol ---------------------------------------------------------
    def get_agent_position(self) -> np.ndarray:
        return np.asarray(self._state.position, np.float64)

    def get_agent_state(self) -> RigidState:
        return self._state

    def geodesic_distance(self, a, b) -> float:
        if self._geo is not None:
            return self._geo.distance(a, b)
        return float(np.linalg.norm(np.asarray(b) - np.asarray(a)))

    # -- observations -----------------------------------------------------------
    def _render(self) -> Dict[str, Any]:
        """Procedural observations keyed by agent pose: cheap, deterministic,
        positionally informative (the renderless stand-in for RGB-D)."""
        h, w = self._rgb_hw
        pos = self.get_agent_position()
        heading = heading_from_quaternion(self._state.rotation)
        yy = np.linspace(0, 1, h, dtype=np.float32)[:, None]
        xx = np.linspace(0, 1, w, dtype=np.float32)[None, :]
        base = (
            np.sin(xx * 7 + pos[0]) + np.cos(yy * 5 + pos[2]) + np.sin(heading)
        )
        rgb = np.stack(
            [base, np.roll(base, h // 7, axis=0), base.T[:h, :w]], axis=-1
        )
        rgb = ((rgb - rgb.min()) / (np.ptp(rgb) + 1e-6) * 255).astype(np.uint8)
        dh, dw = self._depth_hw
        dyy = np.linspace(0, 1, dh, dtype=np.float32)[:, None]
        dxx = np.linspace(0, 1, dw, dtype=np.float32)[None, :]
        depth = (np.abs(np.sin(dxx * 3 + heading) * np.cos(dyy * 4 + pos[0]))).astype(
            np.float32
        )[..., None]
        return {"rgb": rgb, "depth": depth}

    def _oracle_action(self) -> int:
        """Discrete expert action (VLNOracleActionSensor equivalent,
        sensors.py:51-86): 0 stop near goal; else forward/left/right from the
        bearing to the next reference waypoint."""
        ep = self.current_episode
        pos = self.get_agent_position()
        if self.geodesic_distance(pos, ep.goals[0].position) < self.config.TASK_CONFIG.TASK.VLN_ORACLE_ACTION_SENSOR.GOAL_RADIUS:
            return 0
        s, _ = self._geo._project(pos)
        target_s = min(s + 0.25, self._geo.total)
        idx = int(np.searchsorted(self._geo.cum, target_s))
        idx = min(idx, len(self._geo.points) - 1)
        target = self._geo.points[idx]
        to_t = np.asarray(target) - pos
        if np.linalg.norm(to_t) < 1e-6:
            return 0
        heading = heading_from_quaternion(self._state.rotation)
        bearing = float(np.arctan2(-to_t[0], -to_t[2]))
        delta = (bearing - heading + np.pi) % (2 * np.pi) - np.pi
        turn = np.deg2rad(self.config.TASK_CONFIG.SIMULATOR.TURN_ANGLE)
        if abs(delta) < turn:
            return 1  # MOVE_FORWARD
        return 2 if delta > 0 else 3  # TURN_LEFT / TURN_RIGHT

    def _observations(self) -> Dict[str, Any]:
        ep = self.current_episode
        obs: Dict[str, Any] = self._render()
        d_now = self.geodesic_distance(
            self.get_agent_position(), ep.goals[0].position
        )
        d_start = ep.info.get("geodesic_distance") or self._geo.total or 1.0
        obs["instruction"] = {
            "text": ep.instruction.instruction_text,
            "tokens": ep.instruction.instruction_tokens or [],
        }
        obs["vln_oracle_action_sensor"] = np.array([self._oracle_action()], np.float64)
        obs["progress"] = np.array(
            [(d_start - d_now) / d_start], np.float64
        )
        obs["globalgps"] = self.get_agent_position().astype(np.float32)
        obs["heading"] = np.array(
            [heading_from_quaternion(self._state.rotation)], np.float32
        )
        return obs

    # -- env protocol -------------------------------------------------------------
    def reset(self) -> Dict[str, Any]:
        ep = self.dataset.episodes[self._ep_iter % len(self.dataset.episodes)]
        self._ep_iter += 1
        self.current_episode = ep
        self._state = RigidState(
            rotation=habitat_rotation_to_wxyz(ep.start_rotation),
            position=np.asarray(ep.start_position, np.float64),
        )
        ref = list(ep.reference_path) + [ep.goals[0].position]
        self._geo = _PolylineGeodesics(np.asarray(ref))
        self._steps = 0
        self._reset_measures()
        return self._observations()

    def step(self, vel_control: VelocityControl):
        self._state = integrate_rigid_state(self._state, vel_control, self._dt)
        self._steps += 1
        self._update_measures()
        obs = self._observations()
        done = self.get_done()
        return obs, 0.0, done, self.get_metrics()


class ReplayEnv(_BaseEnv):
    """Replays recorded episodes from a trajectory buffer: observations come
    from disk, agent positions from the recorded GPS track.  Mirrors how the
    reference trains sim-free from the LMDB buffer."""

    def __init__(self, config, features_dir: str):
        super().__init__(config)
        self._store = TrajectoryStore(features_dir)
        self._keys = list(range(len(self._store)))
        self._ep_iter = 0
        self._t = 0
        self._episode_obs = None
        self._track = None
        self._setup_measures()

    def get_agent_position(self) -> np.ndarray:
        idx = min(self._t, len(self._track) - 1)
        return self._track[idx]

    def geodesic_distance(self, a, b) -> float:
        return float(np.linalg.norm(np.asarray(b) - np.asarray(a)))

    def reset(self) -> Dict[str, Any]:
        key = self._keys[self._ep_iter % len(self._keys)]
        self._ep_iter += 1
        raw = serialization.unpackb_any(self._store.get_buffer(key))
        obs, prev_actions, actions, stop_step = raw
        self._episode_obs = {k: np.asarray(v) for k, v in obs.items()}
        t_len = len(np.asarray(prev_actions))
        if "globalgps" in self._episode_obs:
            self._track = np.asarray(self._episode_obs["globalgps"], np.float64)
        else:
            self._track = np.zeros((t_len, 3))
        self._t = 0
        goal = self._track[-1]
        self.current_episode = VLNEpisode(
            episode_id=str(key), scene_id="replay",
            start_position=list(self._track[0]),
            start_rotation=[0, 0, 0, 1],
            goals=[NavigationGoal(position=list(goal))],
            instruction=InstructionData(instruction_text=""),
            reference_path=[list(p) for p in self._track],
            info={},
        )
        self._steps = 0
        self._reset_measures()
        return self._frame(0)

    def _frame(self, t: int) -> Dict[str, Any]:
        idx = min(t, len(self._track) - 1)
        out = {}
        for k, v in self._episode_obs.items():
            arr = np.asarray(v)
            out[k] = arr[min(idx, len(arr) - 1)]
        return out

    def step(self, vel_control):
        self._t += 1
        self._steps += 1
        self._update_measures()
        done = (
            self._t >= len(self._track) - 1 or self._steps >= self._max_steps,
            self.get_done()[1],
        )
        return self._frame(self._t), 0.0, done, self.get_metrics()

    def close(self):
        self._store.close()


class HabitatEnv(_BaseEnv):
    """Adapter over the habitat velocity-control forks when installed (the
    reference's actual simulator; environments.py:8-45, env_utils.py:25-114).

    Exposes the same protocol as the other backends; actions are our
    VelocityControl dataclasses, converted to habitat_sim VelocityControl at
    the boundary.  Rewards are zero and done is the
    (episode_over, geodesic < SUCCESS_DISTANCE) pair like VLNCEDaggerEnv.

    Assumed fork API surface (yacs-era habitat-lab ~0.1.x as pinned by the
    reference README.md:63-76; contract-tested against mocked modules in
    tests/test_torch_habitat_adapter.py):
      habitat.get_config() -> yacs node with defrost/merge_from_other_cfg/freeze
      habitat.Config(init_dict=dict)  (yacs CN constructor)
      habitat.Env(config=cfg): .reset(), .step(action_dict), .episode_over,
        .current_episode, .get_metrics(), .sim, .task.actions, .close()
      env.sim: .get_agent_state() -> state with .position and quaternion
        .rotation (w/x/y/z attrs), .geodesic_distance(a, b),
        .set_agent_state(position, rotation), .get_sensor_observations()
      habitat_sim.physics.VelocityControl: controlling_lin_vel,
        lin_vel_is_local, controlling_ang_vel, ang_vel_is_local,
        linear_velocity, angular_velocity, .integrate_transform(dt, rigid)
      habitat_sim.RigidState(rotation, position) -> .translation/.rotation
    Forks exposing a registered VELOCITY_CONTROL task action get the
    action-dict path; otherwise the adapter integrates the rigid state
    directly (fork semantics) and re-renders.
    """

    def __init__(self, config):
        super().__init__(config)
        try:
            import habitat
            import habitat_sim
        except ImportError as e:
            raise ImportError(
                "habitat-lab/habitat-sim are not installed in this image; use "
                "SIMULATOR.TYPE 'kinematic' or 'replay', or install the "
                "velocity-control forks (reference README.md:63-76)."
            ) from e
        self._habitat_sim = habitat_sim
        # hand the raw dict config to habitat's config system
        hab_cfg = habitat.get_config()
        hab_cfg.defrost()
        hab_cfg.merge_from_other_cfg(
            habitat.Config(init_dict=config.TASK_CONFIG.to_dict())
        )
        hab_cfg.freeze()
        self._env = habitat.Env(config=hab_cfg)
        self._setup_measures()

    @property
    def current_episode(self):
        return self._env.current_episode

    @current_episode.setter
    def current_episode(self, _):
        pass  # habitat owns episode iteration

    def get_agent_position(self):
        return np.asarray(self._env.sim.get_agent_state().position, np.float64)

    def get_agent_state(self) -> RigidState:
        st = self._env.sim.get_agent_state()
        q = st.rotation  # quaternion.quaternion (w, x, y, z components)
        return RigidState(
            rotation=np.array([q.w, q.x, q.y, q.z], np.float64),
            position=np.asarray(st.position, np.float64),
        )

    def geodesic_distance(self, a, b) -> float:
        return float(self._env.sim.geodesic_distance(list(a), list(b)))

    def reset(self):
        obs = self._env.reset()
        self._steps = 0
        self._reset_measures()
        return obs

    def step(self, vel_control: VelocityControl):
        hs = self._habitat_sim
        vc = hs.physics.VelocityControl()
        vc.controlling_lin_vel = True
        vc.lin_vel_is_local = True
        vc.controlling_ang_vel = True
        vc.ang_vel_is_local = True
        vc.linear_velocity = list(np.asarray(vel_control.linear_velocity))
        vc.angular_velocity = list(np.asarray(vel_control.angular_velocity))
        obs = self._env.step({"action": "VELOCITY_CONTROL", "action_args": {"vc": vc}}) \
            if "VELOCITY_CONTROL" in getattr(self._env.task, "actions", {}) \
            else self._step_kinematic(vc)
        self._steps += 1
        self._update_measures()
        done = (self._env.episode_over or self._steps >= self._max_steps,
                self.get_done()[1])
        return obs, 0.0, done, {**self._env.get_metrics(), **self.get_metrics()}

    def _step_kinematic(self, vc):
        """Fork-style stepping: integrate the agent state directly and
        re-render (the reference forks step the sim with VelocityControl)."""
        sim = self._env.sim
        st = sim.get_agent_state()
        rigid = self._habitat_sim.RigidState(st.rotation, st.position)
        new_state = vc.integrate_transform(
            self.config.DAGGER.time_step, rigid
        )
        sim.set_agent_state(
            list(new_state.translation), new_state.rotation
        )
        return sim.get_sensor_observations()

    def close(self):
        self._env.close()
