// Kinematic velocity-control integrator (the port's own copy of the
// integrator of robo_vln_tpu/sim/kinematics.cc; the expert's waypoint
// controller there comes with the expert, ROADMAP §A item 5).
//
// Native replacement for habitat-sim's VelocityControl::integrateTransform
// (the C++ simulator fork's continuous-control core the reference depends
// on), stepped at 30 Hz by the kinematic env backend of the eval loop.
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

}  // extern "C"
