"""Velocity-control types, kinematic integration and the expert's waypoint
controller (host-side); the port's own copy of
robo_vln_tpu/envs/velocity_control.py.

Python surface over the native library (sim/kinematics.cc, built by
sim/build.py into build/sim/): the integrator replicates
habitat_sim.physics.VelocityControl semantics (local-frame linear/angular
velocities, translation integrated with the pre-step rotation, then the
rotation update), and :func:`track_waypoint_native` is the expert's
P-controller.  Numpy fallbacks implement identical math; :func:`integrator`
names the library in use for both, and the first call logs it.

Conventions (habitat): -z is forward, +y up; quaternions are (w, x, y, z).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from ..utils.logging import logger

_lib = None


def _native():
    global _lib
    if _lib is None:
        try:
            from ..sim.build import load

            lib = load("kinematics")
            dp = ctypes.POINTER(ctypes.c_double)
            lib.integrate_rigid_state.argtypes = [dp, dp, dp, dp, ctypes.c_double]
            lib.integrate_rigid_state.restype = None
            lib.track_waypoint.argtypes = [
                dp, dp, dp, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                dp, dp,
            ]
            lib.track_waypoint.restype = None
            _lib = lib
        except Exception as e:  # noqa: BLE001 — the numpy path computes the same
            logger.warning(f"native kinematic integrator unavailable ({e})")
            _lib = False
        logger.info(f"kinematic integrator: {integrator()} (and the expert's "
                    "waypoint controller)")
    return _lib or None


def integrator() -> str:
    """"native" (sim/kinematics.cc) or "numpy": the integrator the env
    steps with, and the expert's waypoint controller."""
    return "native" if _native() is not None else "numpy"


@dataclass
class RigidState:
    """(rotation quaternion (w,x,y,z), position (x,y,z))."""

    rotation: np.ndarray = field(
        default_factory=lambda: np.array([1.0, 0, 0, 0])
    )
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))


@dataclass
class VelocityControl:
    """habitat_sim.physics.VelocityControl equivalent."""

    linear_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    angular_velocity: np.ndarray = field(default_factory=lambda: np.zeros(3))
    controlling_lin_vel: bool = True
    lin_vel_is_local: bool = True
    controlling_ang_vel: bool = True
    ang_vel_is_local: bool = True


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    u = np.array([x, y, z])
    return (
        2.0 * np.dot(u, v) * u
        + (w * w - np.dot(u, u)) * v
        + 2.0 * w * np.cross(u, v)
    )


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def integrate_rigid_state_numpy(q: np.ndarray, p: np.ndarray, lin: np.ndarray,
                                ang: np.ndarray, dt: float) -> RigidState:
    """The numpy path of :func:`integrate_rigid_state`, the same math as
    sim/kinematics.cc."""
    p = p + quat_rotate(q, lin * dt)
    w = ang * dt
    angle = float(np.linalg.norm(w))
    if angle > 1e-12:
        axis = w / angle
        dq = np.array(
            [np.cos(angle / 2), *(np.sin(angle / 2) * axis)]
        )
        q = quat_mul(q, dq)
        q = q / np.linalg.norm(q)
    return RigidState(q, p)


def integrate_rigid_state(
    state: RigidState, vc: VelocityControl, dt: float
) -> RigidState:
    q = np.asarray(state.rotation, np.float64).copy()
    p = np.asarray(state.position, np.float64).copy()
    lin = np.asarray(vc.linear_velocity, np.float64).copy()
    ang = np.asarray(vc.angular_velocity, np.float64).copy()
    if not vc.controlling_lin_vel:
        lin[:] = 0
    if not vc.controlling_ang_vel:
        ang[:] = 0
    lib = _native()
    if lib is None:
        return integrate_rigid_state_numpy(q, p, lin, ang, dt)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.integrate_rigid_state(
        q.ctypes.data_as(dp), p.ctypes.data_as(dp),
        lin.ctypes.data_as(dp), ang.ctypes.data_as(dp), dt,
    )
    return RigidState(q, p)


def track_waypoint_numpy(q: np.ndarray, p: np.ndarray, wp: np.ndarray,
                         prev_lin_z: float, progress: float,
                         dt: float) -> Tuple[float, float]:
    """The numpy path of :func:`track_waypoint_native`, the same math as
    sim/kinematics.cc (track_waypoint equations,
    continuous_path_follower.py:124-159)."""
    glob_forward = quat_rotate(q, np.array([0.0, 0.0, -1.0]))
    glob_forward /= np.linalg.norm(glob_forward)
    glob_right = quat_rotate(q, np.array([-1.0, 0.0, 0.0]))
    glob_right /= np.linalg.norm(glob_right)
    to_wp = wp - p
    n = np.linalg.norm(to_wp)
    u = to_wp / n if n > 1e-12 else np.zeros(3)
    angle_error = float(np.arccos(np.clip(np.dot(glob_forward, u), -1, 1)))

    if progress > 0.985:
        new_velocity = prev_lin_z / 1.5
    elif angle_error < 0.5:
        new_velocity = (prev_lin_z - 1.0) / 2.0
    else:
        new_velocity = prev_lin_z / 2.0

    rot_dir = -1.0 if np.dot(glob_right, u) < 0 else 1.0
    max_turn_speed = 1.0
    if angle_error > max_turn_speed * 10.0 * dt:
        angular_correction = max_turn_speed
    else:
        angular_correction = angle_error / 2.0
    w = float(np.clip(rot_dir * angular_correction, -max_turn_speed, max_turn_speed))
    return new_velocity, w


def track_waypoint_native(
    state: RigidState, waypoint: np.ndarray, prev_lin_z: float,
    progress: float, dt: float,
) -> Tuple[float, float]:
    """(new lin_vel.z, ang_vel.y) from the expert P-controller."""
    lib = _native()
    q = np.asarray(state.rotation, np.float64)
    p = np.asarray(state.position, np.float64)
    wp = np.asarray(waypoint, np.float64)
    if lib is None:
        return track_waypoint_numpy(q, p, wp, prev_lin_z, progress, dt)
    dp = ctypes.POINTER(ctypes.c_double)
    out_v = ctypes.c_double()
    out_w = ctypes.c_double()
    lib.track_waypoint(
        q.ctypes.data_as(dp), p.ctypes.data_as(dp), wp.ctypes.data_as(dp),
        prev_lin_z, progress, dt, ctypes.byref(out_v), ctypes.byref(out_w),
    )
    return out_v.value, out_w.value


def heading_from_quaternion(q: np.ndarray) -> float:
    """Yaw of the -z forward vector around +y (heading sensor)."""
    fwd = quat_rotate(np.asarray(q, np.float64), np.array([0.0, 0.0, -1.0]))
    return float(np.arctan2(-fwd[0], -fwd[2]))
