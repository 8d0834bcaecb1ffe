"""The closed-loop evaluation tick of the kinematic task, plain: the
procedural observations at a pose, the HCM agent's tick, the velocity
integration, the polyline geodesic and the termination rule.

It follows a rollout tick by tick from the poses that the rollout under
test recorded (teacher forcing): at each tick it renders the recorded
pose, runs its own agent (its own LSTM states, carried across the ticks,
frozen once an episode is done), integrates the recorded actions from the
recorded pose, and applies the termination rule.  The closed loop's
feedback from one tick's pose to the next is what this skips; the
integration of each tick is compared on its own instead.
"""

from __future__ import annotations

import torch

from . import hcm
from .ops import exact_float32
from .trunks import bert

SUCCESS_DISTANCE = 3.0


# -- the task's math ----------------------------------------------------------------------

def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def rotate(q, v):
    """v rotated by the unit quaternion q (w, x, y, z)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], -1)
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], device=q.device)
    return quat_mul(quat_mul(q, qv), conj)[..., 1:]


def heading(q):
    """Yaw about +y of the agent's forward axis, -z."""
    fwd = rotate(q, torch.tensor([0.0, 0.0, -1.0], device=q.device).expand(q.shape[:-1] + (3,)))
    return torch.atan2(-fwd[..., 0], -fwd[..., 2])


def integrate(q, p, lin, omega, dt):
    """Translate by the body-frame velocity (0, 0, lin) under the pre-step
    rotation, then turn by omega about +y over dt."""
    zero = torch.zeros_like(lin)
    p_new = p + rotate(q, torch.stack([zero, zero, lin], -1) * dt)
    angle = (omega * dt).abs()
    turn = torch.stack([torch.cos(angle / 2), zero, torch.sin(angle / 2) * torch.sign(omega),
                        zero], -1)
    q_new = quat_mul(q, turn)
    q_new = q_new / q_new.norm(dim=-1, keepdim=True)
    return torch.where((angle > 1e-12)[:, None], q_new, q), p_new


def path_distance(points, cum, x, goal):
    """The geodesic along a polyline: the arc positions of x's and the
    goal's nearest points (the first segment on ties) apart, plus both
    offsets from the line.  points (B, K, 3), cum (B, K)."""
    a, b = points[:, :-1], points[:, 1:]
    ab = b - a
    l2 = (ab * ab).sum(-1)

    def nearest(y):
        t = torch.where(l2 > 0, ((y[:, None] - a) * ab).sum(-1) / l2.clamp_min(1e-12), 0.0)
        t = t.clamp(0.0, 1.0)
        d = (y[:, None] - (a + t[..., None] * ab)).norm(dim=-1)
        i = d.argmin(-1, keepdim=True)
        arc = cum[:, :-1] + t * l2.sqrt()
        return arc.gather(1, i)[:, 0], d.gather(1, i)[:, 0]

    sx, dx = nearest(x)
    sg, dg = nearest(goal)
    return (sg - sx).abs() + dx + dg


def render(p, yaw, rgb_hw, depth_hw):
    """The task's procedural frames at positions p (B, 3) and yaws (B,):
    rgb (B, h, w, 3) uint8 from three patterns of sines, each frame spread
    to 0-255 and truncated; depth (B, h', w', 1) float16."""
    (h, w), (dh, dw) = rgb_hw, depth_hw
    dev = p.device

    def axis(n):
        return torch.linspace(0.0, 1.0, n, device=dev)

    yy, xx = axis(h)[None, :, None], axis(w)[None, None, :]
    base = (torch.sin(xx * 7 + p[:, 0, None, None]) + torch.cos(yy * 5 + p[:, 2, None, None])
            + torch.sin(yaw)[:, None, None])
    rgb = torch.stack([base, torch.roll(base, h // 7, dims=1), base.transpose(1, 2)[:, :h, :w]],
                      -1)
    lo = rgb.amin(dim=(1, 2, 3), keepdim=True)
    hi = rgb.amax(dim=(1, 2, 3), keepdim=True)
    rgb = ((rgb - lo) / (hi - lo + 1e-6) * 255).to(torch.uint8)
    dyy, dxx = axis(dh)[None, :, None], axis(dw)[None, None, :]
    depth = (torch.sin(dxx * 3 + yaw[:, None, None]) * torch.cos(dyy * 4 + p[:, 0, None, None]))
    return rgb, depth.abs()[..., None].half()


# -- the tick, followed -------------------------------------------------------------------

@torch.no_grad()
def follow(weights, sizes, episode, record, steps, hw, dt, max_steps, precision="float32",
           block=64):
    """Follow one batch's recorded ticks.  episode: ref_points, cum,
    start_pos, start_rot, instruction (B, L); record: q (T, B, 4), p (T, B,
    3), actions (T, B, 2), stop (T, B, 1), logits (T, B, 4), each as the
    rollout recorded it at tick t (the pose before the tick); steps (B,),
    the rollout's; ``hw`` the rgb and depth (h, w).  Returns the reference's
    logits, actions and stop logits (T, B, ...), the pose after each tick's
    integration of the recorded actions, and its own steps (B,)."""
    ref = hcm.Reference(weights, sizes, precision)
    A, w = ref.A, {**ref.frozen, **ref.params}
    T = int(steps.max())
    q, p = record["q"][:T], record["p"][:T]
    B = q.shape[1]
    with exact_float32(), A.scope():
        emb = bert(A, w, "high.embedding_layer.", episode["instruction"], sizes["bert_heads"])
        # the frames of every tick first, then the trunks over them in blocks
        rgb, depth = render(p.reshape(-1, 3), heading(q.reshape(-1, 4)), *hw)
        feats = [hcm.trunk_features(A, w, rgb[i:i + block], depth[i:i + block])
                 for i in range(0, T * B, block)]
        rgb_f = torch.cat([f[0] for f in feats]).reshape(T, B, *feats[0][0].shape[1:])
        depth_f = torch.cat([f[1] for f in feats]).reshape(T, B, *feats[0][1].shape[1:])
        H = w["high.state_encoder.rnn.weight_hh_l0"].shape[1]
        hh = torch.zeros(2, B, H, device=q.device)
        lh = torch.zeros(2, B, H, device=q.device)
        out = {k: torch.zeros_like(record[k][:T]) for k in ("logits", "actions", "stop")}
        pose_q, pose_p = torch.zeros_like(q), torch.zeros_like(p)
        done = torch.zeros(B, dtype=torch.bool, device=q.device)
        own_steps = torch.zeros(B, dtype=torch.int64, device=q.device)
        goal = episode["ref_points"][:, -1]
        for t in range(T):
            live = ~done & (t < max_steps)
            mask = torch.full((B, 1), float(t > 0), device=q.device)
            logits, hh_new = hcm.high_level(A, w, rgb_f[t], depth_f[t], emb, mask, hh, sizes,
                                            None)
            sub_goal = record["logits"][t].argmax(-1)[:, None]  # the rollout's choice
            actions, stop, lh_new = hcm.low_level(A, w, rgb_f[t], depth_f[t], sub_goal, mask, lh)
            hh = torch.where(live[None, :, None], hh_new, hh)
            lh = torch.where(live[None, :, None], lh_new, lh)
            out["logits"][t], out["actions"][t], out["stop"][t] = logits[:, 0], actions[:, 0], \
                stop[:, 0]
            a = record["actions"][t]
            q2, p2 = integrate(q[t], p[t], a[:, 0], a[:, 1].clamp(-1.0, 1.0), dt)
            pose_q[t] = torch.where(live[:, None], q2, q[t])
            pose_p[t] = torch.where(live[:, None], p2, p[t])
            success = path_distance(episode["ref_points"], episode["cum"], pose_p[t],
                                    goal) < SUCCESS_DISTANCE
            stop_pred = torch.round(torch.sigmoid(record["stop"][t][:, 0]))
            done = done | (live & success & ((a[:, 0] < 0.25) | (stop_pred == 1)))
            own_steps += live.long()
    return {**out, "q_next": pose_q, "p_next": pose_p, "steps": own_steps, "ticks": T}
