"""Continuous expert: arc-length path follower + waypoint tracker (the port's
own copy of robo_vln_tpu/envs/expert.py).

Host-side equivalent of the reference expert
(robo_vln_baselines/common/continuous_path_follower.py:13-159):

* :class:`ContinuousPathFollower` — arc-length parameterized reference path;
  `pos_at(progress)`, waypoint advanced while within the threshold (0.4 m);
* :func:`track_waypoint` — the P-controller, through
  envs/velocity_control.track_waypoint_native (sim/kinematics.cc, or its
  numpy fallback).

The follower needs a `sim.geodesic_distance` for total path length
normalization; the kinematic backend supplies reference-path arc length.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .velocity_control import RigidState, VelocityControl, track_waypoint_native


class ContinuousPathFollower:
    def __init__(self, sim, path: Sequence[Sequence[float]],
                 waypoint_threshold: float):
        self._sim = sim
        self._points = np.asarray(list(path), np.float64)
        if len(self._points) == 0:
            raise ValueError("ContinuousPathFollower needs a path of at least one point")
        self._length = sim.geodesic_distance(path[0], path[-1])
        self._threshold = waypoint_threshold
        self._step_size = 0.01
        self.progress = 0.0
        self.waypoint = np.array(path[0], np.float64)

        point_progress = [0.0]
        segment_tangents: List[np.ndarray] = []
        for ix in range(1, len(self._points)):
            segment = self._points[ix] - self._points[ix - 1]
            seg_len = float(np.linalg.norm(segment))
            tangent = segment / seg_len if seg_len > 0 else segment
            point_progress.append(seg_len / self._length + point_progress[ix - 1])
            segment_tangents.append(tangent)
        segment_tangents.append(segment_tangents[-1] if segment_tangents else
                                np.zeros(3))
        self._point_progress = point_progress
        self._segment_tangents = segment_tangents

    def pos_at(self, progress: float) -> np.ndarray:
        if progress <= 0:
            return self._points[0]
        if progress >= 1.0:
            return self._points[-1]
        path_ix = 0
        for ix, prog in enumerate(self._point_progress):
            if prog > progress:
                path_ix = ix
                break
        segment_distance = self._length * (
            progress - self._point_progress[path_ix - 1]
        )
        return (
            self._points[path_ix - 1]
            + self._segment_tangents[path_ix - 1] * segment_distance
        )

    def update_waypoint(self) -> None:
        if self.progress < 1.0:
            node_pos = np.asarray(self._sim.get_agent_position(), np.float64)
            wp_dist = float(np.linalg.norm(self.waypoint - node_pos))
            while wp_dist < self._threshold:
                self.progress += self._step_size
                self.waypoint = np.asarray(self.pos_at(self.progress), np.float64)
                if self.progress >= 1.0:
                    break
                wp_dist = float(np.linalg.norm(self.waypoint - node_pos))


def track_waypoint(waypoint, rs: RigidState, vc: VelocityControl,
                   progress: float, dt: float = 1.0 / 30.0):
    """The reference track_waypoint: updates vc in place, returns (vel, omega)
    as continuous_path_follower.py:124-159 does."""
    prev_lin_z = float(vc.linear_velocity[2])
    new_v, new_w = track_waypoint_native(rs, waypoint, prev_lin_z, progress, dt)
    vc.linear_velocity = np.array([0.0, 0.0, new_v])
    vc.angular_velocity = np.array([0.0, new_w, 0.0])
    return new_v, new_w
