"""Velocity-control types and kinematic integration (host-side); the port's
own copy of the integrator of robo_vln_tpu/envs/velocity_control.py.

Python surface over the native integrator (sim/kinematics.cc, built by
sim/build.py into build/sim/) replicating habitat_sim.physics.VelocityControl
semantics: local-frame linear/angular velocities, translation integrated
with the pre-step rotation, then the rotation update.  A numpy fallback
implements identical math; :func:`integrator` names the one in use, and the
first step logs it.  The expert's waypoint controller comes with the expert
(ROADMAP §A item 5).

Conventions (habitat): -z is forward, +y up; quaternions are (w, x, y, z).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

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
            _lib = lib
        except Exception as e:  # noqa: BLE001 — the numpy path computes the same
            logger.warning(f"native kinematic integrator unavailable ({e})")
            _lib = False
        logger.info(f"kinematic integrator: {integrator()}")
    return _lib or None


def integrator() -> str:
    """"native" (sim/kinematics.cc) or "numpy": the integrator the env
    steps with."""
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


def heading_from_quaternion(q: np.ndarray) -> float:
    """Yaw of the -z forward vector around +y (heading sensor)."""
    fwd = quat_rotate(np.asarray(q, np.float64), np.array([0.0, 0.0, -1.0]))
    return float(np.arctan2(-fwd[0], -fwd[2]))
