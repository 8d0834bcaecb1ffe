// Kinematic velocity-control integrator and expert waypoint controller (the
// port's own copy of robo_vln_tpu/sim/kinematics.cc).
//
// Native replacement for habitat-sim's VelocityControl::integrateTransform
// (the C++ simulator fork's continuous-control core the reference depends
// on), stepped at 30 Hz by the kinematic env backend of the eval loop and of
// collection, plus the hot inner math of the expert P-controller
// (robo_vln_baselines/common/continuous_path_follower.py:124-159).
//
// Quaternions are (w, x, y, z); all frames follow habitat: -z forward, +y up.
// integrate_rigid_state applies the translation with the ORIGINAL rotation,
// then updates the rotation (matching VelocityControl::integrateTransform).

#include <cmath>

namespace {

struct Quat {
  double w, x, y, z;
};

Quat qmul(const Quat& a, const Quat& b) {
  return {
      a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
      a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
      a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
      a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w,
  };
}

void qrotate(const Quat& q, const double* v, double* out) {
  // v' = q v q^-1
  Quat p{0, v[0], v[1], v[2]};
  Quat qi{q.w, -q.x, -q.y, -q.z};
  Quat r = qmul(qmul(q, p), qi);
  out[0] = r.x;
  out[1] = r.y;
  out[2] = r.z;
}

Quat qnormalize(const Quat& q) {
  double n = std::sqrt(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z);
  if (n == 0) return {1, 0, 0, 0};
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

}  // namespace

extern "C" {

// quat: (w,x,y,z) in/out; pos: (x,y,z) in/out.
// lin_vel / ang_vel: local-frame velocity vectors (habitat convention).
void integrate_rigid_state(double* quat, double* pos, const double* lin_vel,
                           const double* ang_vel, double dt) {
  Quat q{quat[0], quat[1], quat[2], quat[3]};
  // translation with the ORIGINAL rotation
  double v_scaled[3] = {lin_vel[0] * dt, lin_vel[1] * dt, lin_vel[2] * dt};
  double world_disp[3];
  qrotate(q, v_scaled, world_disp);
  pos[0] += world_disp[0];
  pos[1] += world_disp[1];
  pos[2] += world_disp[2];
  // then rotation: q' = q * exp(ang_vel * dt)
  double wx = ang_vel[0] * dt, wy = ang_vel[1] * dt, wz = ang_vel[2] * dt;
  double angle = std::sqrt(wx * wx + wy * wy + wz * wz);
  if (angle > 1e-12) {
    double s = std::sin(angle / 2) / angle;
    Quat dq{std::cos(angle / 2), wx * s, wy * s, wz * s};
    q = qnormalize(qmul(q, dq));
  }
  quat[0] = q.w;
  quat[1] = q.x;
  quat[2] = q.y;
  quat[3] = q.z;
}

// Expert waypoint tracker (track_waypoint equations): given the agent's rigid
// state, the current waypoint, the previous linear velocity (z component,
// local) and progress, produce new (lin_vel_z, ang_vel_y).
void track_waypoint(const double* quat, const double* pos,
                    const double* waypoint, double prev_lin_z, double progress,
                    double dt, double* out_lin_z, double* out_ang_y) {
  const double angular_error_threshold = 0.5;
  const double max_linear_speed = 1.0;
  const double max_turn_speed = 1.0;
  Quat q{quat[0], quat[1], quat[2], quat[3]};

  double fwd_local[3] = {0, 0, -1.0};
  double right_local[3] = {-1.0, 0, 0};
  double glob_forward[3], glob_right[3];
  qrotate(q, fwd_local, glob_forward);
  qrotate(q, right_local, glob_right);

  double to_wp[3] = {waypoint[0] - pos[0], waypoint[1] - pos[1],
                     waypoint[2] - pos[2]};
  double n = std::sqrt(to_wp[0] * to_wp[0] + to_wp[1] * to_wp[1] +
                       to_wp[2] * to_wp[2]);
  double u[3] = {0, 0, 0};
  if (n > 1e-12) {
    u[0] = to_wp[0] / n;
    u[1] = to_wp[1] / n;
    u[2] = to_wp[2] / n;
  }
  double fn = std::sqrt(glob_forward[0] * glob_forward[0] +
                        glob_forward[1] * glob_forward[1] +
                        glob_forward[2] * glob_forward[2]);
  double dot_f = (glob_forward[0] * u[0] + glob_forward[1] * u[1] +
                  glob_forward[2] * u[2]) /
                 (fn > 0 ? fn : 1.0);
  if (dot_f > 1.0) dot_f = 1.0;
  if (dot_f < -1.0) dot_f = -1.0;
  double angle_error = std::acos(dot_f);

  double new_velocity;
  if (progress > 0.985) {
    new_velocity = prev_lin_z / 1.5;  // decay to stop
  } else if (angle_error < angular_error_threshold) {
    new_velocity = (prev_lin_z - max_linear_speed) / 2.0;  // toward -1 (fwd)
  } else {
    new_velocity = prev_lin_z / 2.0;
  }

  double rot_dir =
      (glob_right[0] * u[0] + glob_right[1] * u[1] + glob_right[2] * u[2]) < 0
          ? -1.0
          : 1.0;
  double angular_correction = (angle_error > max_turn_speed * 10.0 * dt)
                                  ? max_turn_speed
                                  : angle_error / 2.0;
  double w = rot_dir * angular_correction;
  if (w > max_turn_speed) w = max_turn_speed;
  if (w < -max_turn_speed) w = -max_turn_speed;

  *out_lin_z = new_velocity;
  *out_ang_y = w;
}

}  // extern "C"
