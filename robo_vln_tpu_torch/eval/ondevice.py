"""On-device closed-loop eval for the kinematic backend (``EVAL.ON_DEVICE``;
counterpart of robo_vln_tpu/eval/ondevice.py).

The host driver (eval/evaluator.py) pays a host-device round trip and a
host-side sim step every 30 Hz control tick.  On the kinematic backend every
piece of the loop is plain math (velocity integration by quaternion, the
procedural observations, the polyline geodesics, the termination), so here
the whole rollout stays on the device, in float32: one tick
(:meth:`Rollout.tick`) renders, runs the policy, integrates and terminates
the batch in place on static buffers.  On a CUDA device each batch replays a
CUDA graph of :data:`GRAPH_TICKS` ticks, both kernels (the LSTM's and the
attention's) captured in it, and reads back one flag a replay to stop when
every episode is done or at ``MAX_EPISODE_STEPS``; on the CPU the same tick
runs eagerly.  A batch's episode arrays go to the device in one pinned copy
each and its results come back in one copy; the measures (nDTW, SPL, ...)
are computed on the host from the position trace, as the host driver
computes them.

A fast path, not the parity path: the sim runs in float32 on the device
against the host's float64, so closed loops may part; the math of each
piece is held to the host's and to the JAX package's in
tests/test_torch_ondevice.py.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..envs.env import _PolylineGeodesics, habitat_rotation_to_wxyz
from ..ops import fused_attention, fused_lstm
from ..tasks.dtw import ndtw

# ticks a CUDA graph holds: a batch syncs once a replay, and runs at most
# GRAPH_TICKS - 1 ticks past its last episode's end, each an exact no-op
GRAPH_TICKS = 4
WARMUP_TICKS = 1  # eager ticks on the capture stream before the capture


# -- the sim math, float32 on the device --------------------------------------------

def quat_mul(a, b):
    """(w, x, y, z) Hamilton product (envs/velocity_control.quat_mul)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4), wxyz."""
    w, u = q[..., :1], q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def integrate_rigid_state(q, p, lin, ang, dt: float):
    """habitat's VelocityControl.integrate_transform: translate with the
    pre-step rotation, then rotate (envs/velocity_control.py)."""
    p_new = p + quat_rotate(q, lin * dt)
    w = ang * dt
    angle = torch.linalg.norm(w, dim=-1, keepdim=True)
    axis = w / angle.clamp_min(1e-12)
    half = angle / 2.0
    dq = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    q_new = quat_mul(q, dq)
    q_new = q_new / torch.linalg.norm(q_new, dim=-1, keepdim=True)
    return torch.where(angle > 1e-12, q_new, q), p_new


def heading_from_quaternion(q):
    """Yaw of the -z forward vector around +y."""
    forward = torch.zeros_like(q[..., 1:])
    forward[..., 2] = -1.0
    fwd = quat_rotate(q, forward)
    return torch.atan2(-fwd[..., 0], -fwd[..., 2])


def polyline_distance(points, cum, p, goal):
    """The polyline geodesic oracle (envs/env._PolylineGeodesics.distance):
    |Δ arc position| plus both perpendicular offsets.  points (B, K, 3),
    padded by repeating the goal (zero-length tail segments are inert), cum
    (B, K) their arc positions, p and goal (B, 3).  Ties between segments
    take the first, as the host's strict ``<`` does."""
    a, b = points[:, :-1], points[:, 1:]
    ab = b - a
    l2 = (ab * ab).sum(-1)
    seg_len = torch.sqrt(l2)

    def project(x):
        ap = x[:, None, :] - a
        t = torch.where(l2 > 0, (ap * ab).sum(-1) / l2.clamp_min(1e-12), 0.0).clamp(0.0, 1.0)
        d = torch.linalg.norm(x[:, None, :] - (a + t[..., None] * ab), dim=-1)
        best = torch.argmin(d, dim=-1, keepdim=True)
        s_at = cum[:, :-1] + t * seg_len
        return s_at.gather(1, best)[:, 0], d.gather(1, best)[:, 0]

    sa, da = project(p)
    sb, db = project(goal)
    return (sb - sa).abs() + da + db


def render_grids(rgb_hw, depth_hw, device):
    """The render's constant coordinate grids (yy, xx, dyy, dxx), made once."""
    (h, w), (dh, dw) = rgb_hw, depth_hw

    def lin(n):
        return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)

    return lin(h)[None, :, None], lin(w)[None, None, :], lin(dh)[None, :, None], \
        lin(dw)[None, None, :]


def render_obs(pos, heading, rgb_hw, depth_hw, grids=None):
    """The procedural observations of the host's kinematic env
    (envs/env.KinematicEnv._render) over a batch of poses: rgb (B, h, w, 3)
    uint8, the float cast truncating as numpy's does, and depth (B, dh, dw,
    1) float16."""
    yy, xx, dyy, dxx = grids if grids is not None else render_grids(rgb_hw, depth_hw,
                                                                    pos.device)
    h, w = rgb_hw
    base = (torch.sin(xx * 7 + pos[:, 0:1, None]) + torch.cos(yy * 5 + pos[:, 2:3, None])
            + torch.sin(heading)[:, None, None])  # (B, h, w)
    rgb = torch.stack([base, torch.roll(base, h // 7, dims=1),
                       base.transpose(1, 2)[:, :h, :w]], dim=-1)
    lo = rgb.amin(dim=(1, 2, 3), keepdim=True)
    ptp = rgb.amax(dim=(1, 2, 3), keepdim=True) - lo
    rgb = ((rgb - lo) / (ptp + 1e-6) * 255).to(torch.uint8)
    depth = torch.abs(torch.sin(dxx * 3 + heading[:, None, None])
                      * torch.cos(dyy * 4 + pos[:, 0:1, None]))[..., None]
    return rgb, depth.to(torch.float16)


# -- the rollout ---------------------------------------------------------------------

def kernel_launches() -> Dict[str, int]:
    """The wrappers' launch counts: the LSTM's forward and the attention's."""
    return {"lstm_seq": fused_lstm.launches, "cross_modal_attn": fused_attention.launches}


class Rollout:
    """The whole closed-loop rollout of ``batch_size`` episodes on one device.

    ``policy_step(obs, hidden, prev, mask) -> (actions (B, 2), stop (B, 1),
    hidden)`` takes the single-tick observations (rgb, depth, progress,
    instruction and its ``instruction_embedding``: BERT's for the HCM agent,
    the instruction encoder's for a flat policy) and must stay on the
    device.  The carry is the JAX package's: t, q, p, hidden, prev, done,
    steps, succ and the trace (MAX_EPISODE_STEPS, B, 3), each a static
    buffer that :meth:`tick` updates in place.

    On CUDA, :meth:`run` captures :data:`GRAPH_TICKS` ticks into one CUDA
    graph on the first batch: :data:`WARMUP_TICKS` eager ticks on the
    capture stream first (they build the kernels and run their one-time
    set-up: the LSTM's occupancy probe, each attention instance's shared
    memory attribute), then the capture, every LSTM launch going through the
    rollout's own workspace (``fused_lstm.private_workspace``).  A capture
    that fails raises; nothing falls back to eager ticks.  The wrappers'
    launch counters advance only while the graph is captured, never at a
    replay: :attr:`graph_launches` holds a graph's launches, so a batch's
    launches are those times its replays."""

    def __init__(self, policy_step: Callable, config, batch_size: int, hidden,
                 device, graph_ticks: int = GRAPH_TICKS):
        tc = config.TASK_CONFIG
        self.policy_step = policy_step
        self.rgb_hw = (tc.SIMULATOR.RGB_SENSOR.HEIGHT, tc.SIMULATOR.RGB_SENSOR.WIDTH)
        self.depth_hw = (tc.SIMULATOR.DEPTH_SENSOR.HEIGHT, tc.SIMULATOR.DEPTH_SENSOR.WIDTH)
        self.success_distance = tc.TASK.SUCCESS_DISTANCE
        self.dt = config.DAGGER.time_step
        self.max_steps = tc.ENVIRONMENT.MAX_EPISODE_STEPS
        self.B = batch_size
        self.device = torch.device(device)
        self.graph_ticks = graph_ticks
        self.grids = render_grids(self.rgb_hw, self.depth_hw, self.device)
        B, dev = batch_size, self.device
        self.state = {
            "t": torch.zeros((), dtype=torch.int64, device=dev),
            "q": torch.zeros(B, 4, device=dev), "p": torch.zeros(B, 3, device=dev),
            "hidden": tuple(torch.zeros_like(h) for h in hidden),
            "prev": torch.zeros(B, 2, device=dev),
            "done": torch.zeros(B, dtype=torch.bool, device=dev),
            "steps": torch.zeros(B, dtype=torch.int32, device=dev),
            "succ": torch.zeros(B, dtype=torch.bool, device=dev),
            "traces": torch.zeros(self.max_steps, B, 3, device=dev),
            "running": torch.zeros((), dtype=torch.bool, device=dev),
        }
        self.episode: Dict[str, torch.Tensor] = {}
        H = max(h.shape[-1] for h in hidden)
        self.workspace = fused_lstm.make_workspace(dev, B, H)
        self.graph = None
        self.warmup_ms = self.capture_ms = None
        self.graph_launches: Dict[str, int] = {}
        self.batches = []  # per batch: ticks, replays, host syncs, replay events

    # -- inputs and state --------------------------------------------------------
    def load(self, packed: Dict[str, np.ndarray], instruction: np.ndarray,
             embedding: torch.Tensor) -> None:
        """Copy one batch's episode arrays (:func:`pack_episodes`), token
        ids (B, L) and instruction embedding into the static inputs (made
        on the first batch; a later batch must have the same shapes)."""
        cuda = self.device.type == "cuda"
        arrays = {**packed, "instruction": instruction}
        for k, v in arrays.items():
            src = torch.from_numpy(np.ascontiguousarray(v))
            if k not in self.episode:
                self.episode[k] = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            self.episode[k].copy_(src.pin_memory() if cuda else src, non_blocking=cuda)
        if "instruction_embedding" not in self.episode:
            self.episode["instruction_embedding"] = torch.empty_like(embedding)
        self.episode["instruction_embedding"].copy_(embedding)

    def reset(self) -> None:
        """The carry at t = 0: the episodes' start poses, everything else 0."""
        st = self.state
        for k, v in st.items():
            if k == "hidden":
                for h in v:
                    h.zero_()
            elif k not in ("q", "p"):
                v.zero_()
        st["q"].copy_(self.episode["start_rot"])
        st["p"].copy_(self.episode["start_pos"])
        st["running"].fill_(True)

    def snapshot(self) -> Dict:
        """A copy of the carry, for :meth:`restore`."""
        return {k: tuple(h.clone() for h in v) if k == "hidden" else v.clone()
                for k, v in self.state.items()}

    def restore(self, snap: Dict) -> None:
        for k, v in snap.items():
            if k == "hidden":
                for h, s in zip(self.state[k], v):
                    h.copy_(s)
            else:
                self.state[k].copy_(v)

    # -- one tick -----------------------------------------------------------------
    def tick(self) -> None:
        """One control tick of the whole batch, in place: the JAX package's
        while-loop body.  Episodes already done freeze their pose, LSTM
        states and prev; success is measured at the post-step position, and
        an episode ends on it when its raw lin_vel is below 0.25 or its stop
        rounds to 1.  A tick once every episode is done, or at
        MAX_EPISODE_STEPS, changes nothing (the while loop's exit)."""
        st, ep, B = self.state, self.episode, self.B
        t, q, p, prev, done = st["t"], st["q"], st["p"], st["prev"], st["done"]
        points, cum, goal = ep["ref_points"], ep["cum"], ep["ref_points"][:, -1]
        live = ~done & (t < self.max_steps)
        any_live = live.any()
        d_goal = polyline_distance(points, cum, p, goal)
        rgb, depth = render_obs(p, heading_from_quaternion(q), self.rgb_hw, self.depth_hw,
                                self.grids)
        obs = {"rgb": rgb, "depth": depth,
               "progress": ((ep["start_geo"] - d_goal) / ep["start_geo"])[:, None],
               "instruction": ep["instruction"],
               "instruction_embedding": ep["instruction_embedding"]}
        mask = (t > 0).float().expand(B).contiguous()
        actions, stop, new_hidden = self.policy_step(obs, st["hidden"], prev, mask)
        lin, om = actions[:, 0], actions[:, 1].clamp(-1.0, 1.0)  # ω clipped, v not
        zero = torch.zeros_like(lin)
        q2, p2 = integrate_rigid_state(q, p, torch.stack([zero, zero, lin], -1),
                                       torch.stack([zero, om, zero], -1), self.dt)
        keep = ~live
        q_new = torch.where(keep[:, None], q, q2)
        p_new = torch.where(keep[:, None], p, p2)
        hidden_new = [torch.where(keep.view(1, B, 1), old, new)
                      for new, old in zip(new_hidden, st["hidden"])]
        prev_new = torch.where(keep[:, None], prev, actions)
        success = polyline_distance(points, cum, p_new, goal) < self.success_distance
        stop_pred = torch.round(torch.sigmoid(stop[:, 0]))  # half to even, as jnp.round
        newly = live & success & ((lin < 0.25) | (stop_pred == 1))
        done_new = done | newly
        row = t.clamp(max=self.max_steps - 1).view(1)
        trace = torch.where(any_live, p_new, st["traces"].index_select(0, row)[0])
        t_new = t + any_live.long()

        q.copy_(q_new)
        p.copy_(p_new)
        for h, new in zip(st["hidden"], hidden_new):
            h.copy_(new)
        prev.copy_(prev_new)
        st["steps"].add_(live.int())
        st["succ"].logical_or_(newly)
        done.copy_(done_new)
        st["traces"].index_copy_(0, row, trace[None])
        t.copy_(t_new)
        st["running"].copy_(~done_new.all() & (t_new < self.max_steps))

    def _ticks(self) -> None:
        for _ in range(self.graph_ticks):
            self.tick()

    def _capture(self) -> None:
        dev = self.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with fused_lstm.private_workspace(self.workspace):
            t0 = time.perf_counter()
            with torch.cuda.stream(stream):
                for _ in range(WARMUP_TICKS):
                    self.tick()
            torch.cuda.current_stream(dev).wait_stream(stream)
            torch.cuda.synchronize(dev)
            self.warmup_ms = (time.perf_counter() - t0) * 1e3
            before = kernel_launches()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self._ticks()
            torch.cuda.synchronize(dev)
            self.capture_ms = (time.perf_counter() - t0) * 1e3
        after = kernel_launches()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self.graph = graph

    # -- one batch ------------------------------------------------------------------
    def run(self, graph=None) -> Dict[str, np.ndarray]:
        """Run the loaded batch from t = 0 to its end and return, on the
        host: positions (MAX_EPISODE_STEPS, B, 3) (rows past a batch's last
        tick zero), done, steps, actual_success, final_pos and n_ticks, the
        JAX while loop's exit t (= max(steps)).  ``graph`` (default: on
        CUDA) replays the captured graph; otherwise the same ticks run
        eagerly, GRAPH_TICKS at a time.  Host syncs: one flag read a replay
        and one read of the results."""
        cuda = self.device.type == "cuda"
        use_graph = cuda if graph is None else graph
        if use_graph and self.graph is None:
            self.reset()
            self._capture()
        self.reset()
        record = {"replays": 0, "syncs": 0, "events": [], "graph": use_graph}
        with fused_lstm.private_workspace(self.workspace):
            while True:
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                self.graph.replay() if use_graph else self._ticks()
                if cuda:
                    end.record()
                    record["events"].append((start, end))
                record["replays"] += 1
                record["syncs"] += 1
                if not bool(self.state["running"]):
                    break
        result = self.fetch()
        record["syncs"] += 1
        record["ticks"] = int(result["n_ticks"])
        self.batches.append(record)
        return result

    def fetch(self) -> Dict[str, np.ndarray]:
        """The carry's results on the host, in one device-to-host copy."""
        st, B, T = self.state, self.B, self.max_steps
        flat = torch.cat([st["traces"].reshape(-1), st["p"].reshape(-1),
                          st["steps"].float(), st["done"].float(), st["succ"].float(),
                          st["t"].float().view(1)]).cpu().numpy()
        n = T * B * 3
        return {"positions": flat[:n].reshape(T, B, 3),
                "final_pos": flat[n:n + 3 * B].reshape(B, 3),
                "steps": flat[n + 3 * B:n + 4 * B].astype(np.int32),
                "done": flat[n + 4 * B:n + 5 * B] > 0,
                "actual_success": flat[n + 5 * B:n + 6 * B] > 0,
                "n_ticks": int(flat[-1])}


# -- the host side: episodes -> batches -> measures ------------------------------------

def pack_episodes(episodes, k_points: int) -> Dict[str, np.ndarray]:
    """Each episode's reference path and goal, padded to ``k_points`` by
    repeating the goal, with cumulative arc positions; start poses and the
    dataset geodesic (SPL's convention), float32."""
    B = len(episodes)
    pts = np.zeros((B, k_points, 3), np.float32)
    for i, ep in enumerate(episodes):
        ref = ([list(p) for p in ep.reference_path] + [list(ep.goals[0].position)])[:k_points]
        pts[i, :len(ref)] = np.asarray(ref, np.float32)
        pts[i, len(ref):] = pts[i, len(ref) - 1]
    seg = np.linalg.norm(pts[:, 1:] - pts[:, :-1], axis=-1)
    cum = np.concatenate([np.zeros((B, 1), np.float32), np.cumsum(seg, axis=1)], axis=1)
    start_pos = np.asarray([ep.start_position for ep in episodes], np.float32)
    start_rot = np.asarray([habitat_rotation_to_wxyz(ep.start_rotation) for ep in episodes],
                           np.float32)
    start_geo = np.asarray([float(ep.info.get("geodesic_distance") or cum[i, -1] or 1.0)
                            for i, ep in enumerate(episodes)], np.float32)
    return {"ref_points": pts, "cum": cum, "start_pos": start_pos, "start_rot": start_rot,
            "start_geo": start_geo}


def episode_stats(result: Dict, episode, i: int, gt_json, sd: float) -> Dict:
    """Episode ``i``'s measures from the device trace, by the host measures'
    formulas on the polyline oracle.  ``sd`` is the caller's success
    distance for success, SPL and nDTW alike (the evaluator passes
    NDTW.SUCCESS_DISTANCE, as the JAX package does; the host driver's
    success measure reads SUCCESS.SUCCESS_DISTANCE)."""
    steps = int(result["steps"][i])
    trace = np.asarray(result["positions"][:max(steps, 1), i])
    locations = [list(np.asarray(episode.start_position, np.float64))] + [
        list(map(float, p)) for p in trace]
    path_length = float(np.linalg.norm(np.diff(np.asarray(locations), axis=0), axis=1).sum())
    goal = np.asarray(episode.goals[0].position, np.float64)
    ref = np.asarray([list(p) for p in episode.reference_path] + [list(goal)], np.float64)
    geo = _PolylineGeodesics(ref)
    d_goal = geo.distance(np.asarray(result["final_pos"][i], np.float64), goal)
    success = float(d_goal < sd)
    start_geo = float(episode.info.get("geodesic_distance") or geo.total or 1.0)
    gt_locations = gt_json.get(str(episode.episode_id), {}).get(
        "locations", [list(p) for p in ref])
    return {
        "distance_to_goal": float(d_goal),
        "navigation_error": float(d_goal),
        "success": success,
        "spl": success * start_geo / max(start_geo, path_length, 1e-8),
        "path_length": path_length,
        "steps_taken": float(steps),
        "ndtw": ndtw(locations, gt_locations, sd),
        "actual_success": float(bool(result["actual_success"][i])),
    }
