"""The on-device evaluation driver: the port's closed-loop rollout
(``eval/ondevice.Rollout`` over ``eval/agent.HCMAgent.step``, its BERT once a
batch through ``HCMAgent.embed_instruction``), batch after batch, as the
evaluator's ``_eval_on_device`` drives it.

Set-up: the port's config, the weights made on the card from the seed (the
low level's velocity head biased so that the agent drives at the task's
expert's 1 m/s, and its rows scaled down so that the speed holds from seed
to seed and the agent steers little: an episode ends when its path does, at
different ticks), the agent and the rollout built once, and one
batch run whole, which captures the rollout's CUDA graph.  The window:
batches of synthetic episodes loaded and run back to back until
``--seconds`` have passed; the batch that crosses the mark runs to its end
and the window with it.  The batches come from a fixed pool (drawn from
the mix's ``pool_seed``) in an order drawn from the seed, so that every
seed does the same work in another order.

Each tick's pose (before the tick), actions, stop logit and high-level
logits are copied into static buffers by the harness's wrapper of the
policy step and a forward hook on the high level, inside the graph, and
kept for each batch on the card.  After the window a sample of the
window's batches (drawn from the seed, the longest among them) is followed
tick by tick by the reference (hcmbench/reference/rollout.py).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .. import harness
from ..weights import make_weights
from .train import checks  # noqa: F401  (the comparison with the cell's limits)

RECORD_KEYS = {"q": 4, "p": 3, "actions": 2, "stop": 1, "logits": 4}


def episodes(rng, batch, cfg, mix):
    """One batch of synthetic episodes: a reference path of ``path_m``
    metres (drawn) in 1 to ``max_segments`` segments turning up to
    ``max_turn_rad`` each, from a start facing along the first, and BERT
    ids; the arrays the rollout loads."""
    k = mix["max_segments"] + 2
    pts = np.zeros((batch, k, 3), np.float32)
    rot = np.zeros((batch, 4), np.float32)
    lengths = np.zeros(batch, np.float32)
    for i in range(batch):
        length = rng.uniform(*mix["path_m"])
        segments = int(rng.integers(1, mix["max_segments"] + 1))
        yaw = rng.uniform(-np.pi, np.pi)
        rot[i] = [np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0]
        point = np.array([rng.uniform(-5, 5), 0.0, rng.uniform(-5, 5)])
        pts[i, 0] = point
        for s in range(segments):
            point = point + length / segments * np.array([-np.sin(yaw), 0.0, -np.cos(yaw)])
            pts[i, s + 1] = point
            yaw += rng.uniform(-mix["max_turn_rad"], mix["max_turn_rad"])
        pts[i, segments + 1:] = pts[i, segments]  # the goal repeated: inert segments
        lengths[i] = length
    seg = np.linalg.norm(pts[:, 1:] - pts[:, :-1], axis=-1)
    cum = np.concatenate([np.zeros((batch, 1), np.float32), np.cumsum(seg, axis=1)], axis=1)
    vocab = cfg.MODEL.BERT.vocab_size
    ids = rng.integers(min(1000, vocab // 2), vocab, (batch, mix["instruction_len"]))
    return ({"ref_points": pts, "cum": cum.astype(np.float32), "start_pos": pts[:, 0].copy(),
             "start_rot": rot, "start_geo": lengths}, ids.astype(np.int32))


class Recorder:
    """Static buffers of each tick's pose and outputs, written at row t."""

    def __init__(self, rollout, B, max_steps, device):
        self.rollout = rollout
        self.buf = {k: torch.zeros(max_steps + 1, B, n, device=device)
                    for k, n in RECORD_KEYS.items()}
        self.max_steps = max_steps

    def row(self):
        return self.rollout.state["t"].clamp(max=self.max_steps).view(1)

    def put(self, key, value):
        self.buf[key].index_copy_(0, self.row(), value.float().reshape(1, *self.buf[key].shape[1:]))

    def wrap(self, policy_step):
        def step(obs, hidden, prev, mask):
            self.put("q", self.rollout.state["q"])
            self.put("p", self.rollout.state["p"])
            actions, stop, new_hidden = policy_step(obs, hidden, prev, mask)
            self.put("actions", actions)
            self.put("stop", stop)
            return actions, stop, new_hidden
        return step

    def hook(self, module, inputs, output):
        self.put("logits", output[0])

    def copy(self):
        return {k: v.clone() for k, v in self.buf.items()}


class Eval:
    def __init__(self, cell, device):
        from robo_vln_tpu_torch.eval.agent import HCMAgent
        from robo_vln_tpu_torch.eval.ondevice import Rollout
        from robo_vln_tpu_torch.ops import cm_attention

        self.cell, self.device = cell, device
        fam = self.fam = harness.family(cell)
        mix, config = cell.mix, cell.config
        cfg = self.cfg = fam.port_config(config, torch.device(device).type, {
            "EVAL.ON_DEVICE_BATCH": mix["batch"],
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS": mix["max_steps"]})
        weights = fam.tie(make_weights(fam.weight_shapes(cfg), cell.seed, device))
        # the agent drives at the bias's speed and steers little (the head's
        # rows scaled): an episode's length follows its path, alike for
        # every seed
        weights["low.linear.bias"] += torch.tensor(mix["velocity_bias"], device=device)
        weights["low.linear.weight"] *= torch.tensor(mix["velocity_row_scale"],
                                                     device=device)[:, None]
        self.weights = weights
        cm_attention.set_float32_probabilities(cfg.TPU.PALLAS_ATTENTION)
        (_, high), (_, low) = fam.modules(cfg)
        levels = []
        for prefix, m in (("high.", high), ("low.", low)):
            m = m.to_empty(device=device)
            m.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                               if k.startswith(prefix)})
            levels.append(m)
        self.agent = HCMAgent(*levels, share_frozen_trunks=cfg.TPU.SHARE_FROZEN_TRUNKS)
        B = mix["batch"]
        self.B, self.max_steps = B, mix["max_steps"]
        # the rollout calls the recorder's wrapper of the agent's step, and
        # the recorder reads the rollout's tick counter and pose
        self.rollout = Rollout(lambda *a: self.policy(*a), cfg, B,
                               self.agent.initial_state(B), device)
        self.recorder = Recorder(self.rollout, B, self.max_steps, device)
        self.policy = self.recorder.wrap(self.agent.step)
        self.hook = self.agent.high.register_forward_hook(self.recorder.hook)
        # a fixed pool of batches, run in the seed's order: every seed does
        # the same work
        pool_rng = np.random.default_rng(mix["pool_seed"])
        self.pool = [episodes(pool_rng, B, cfg, mix) for _ in range(mix["pool_batches"])]
        self.order = np.random.default_rng(cell.seed).permutation(len(self.pool))
        self.batches = []

    def batch(self, keep=True):
        """Load and run one batch whole; keep its inputs and records on the
        card when ``keep``."""
        packed, ids = self.pool[self.order[len(self.batches) % len(self.pool)]]
        emb = self.agent.embed_instruction(torch.from_numpy(ids).to(self.device), ids)
        self.rollout.load(packed, ids, emb)
        result = self.rollout.run()
        rec = self.rollout.batches[-1]
        out = {"steps": result["steps"], "n_ticks": result["n_ticks"],
               "final_pos": result["final_pos"],
               "replays": rec["replays"], "events": rec.get("events", [])}
        if keep:
            out["episode"] = {k: v.clone() for k, v in self.rollout.episode.items()}
            out["record"] = self.recorder.copy()
        self.batches.append(out)
        return out


def _replay_tick_ms(batches, graph_ticks):
    """Each replay's tick time from the rollout's own CUDA events (a rollout
    without its graph has none)."""
    if not batches or not batches[0]["events"]:
        return []
    harness.CARD.sync()
    return [s.elapsed_time(e) / graph_ticks for b in batches for s, e in b["events"]]


def run(cell, t0):
    from robo_vln_tpu_torch.eval.ondevice import GRAPH_TICKS

    card = harness.CARD
    ev = Eval(cell, card.device)
    mix = cell.mix
    for _ in range(mix["warmup_batches"]):
        ev.batch(keep=False)
    card.sync()
    record = {"setup_s": time.time() - t0, "batch": ev.B, "graph_ticks": GRAPH_TICKS}
    first = len(ev.batches)
    if cell.trace:
        # batches timed by the host's clock and the rollout's events
        # (occupancy, mfu, the tick's tail), then graph replays profiled,
        # the card alone and host and card
        t1 = time.perf_counter()
        for _ in range(mix["trace_batches"]):
            ev.batch()
        card.sync()
        record["untraced_window_s"] = time.perf_counter() - t1
        window = ev.batches[first:]
        if card.traces:
            for key, host in (("trace", False), ("host_trace", True)):
                record[key] = _traced_batch(ev, mix["trace_replays"], host)
        record["trace_steps"] = mix["trace_replays"]
        record["kernel_calls"] = ev.fam.kernel_calls_tick(ev.cfg, mix, ev.B, GRAPH_TICKS)
        record["flops_per_tick"] = tick_flops(cell, ev)
    else:
        t1 = time.perf_counter()
        while True:
            ev.batch()
            if time.perf_counter() - t1 >= cell.seconds:
                break
        card.sync()
        record["window_s"] = time.perf_counter() - t1
        window = ev.batches[first:]
    record["tick_ms"] = _replay_tick_ms(window, GRAPH_TICKS)
    record["live_ticks"] = int(sum(int(b["steps"].sum()) for b in window))
    record["ticks_stepped"] = int(sum(b["n_ticks"] for b in window))
    record["replays"] = int(sum(b["replays"] for b in window))
    peak = card.peak_bytes()
    out = {"attempted": len(window) * ev.B, "failed": 0, "peak": peak, "record": record}
    out["numbers"], out["reference_s"] = check(cell, ev, window)
    return out


def _traced_batch(ev, replays, host):
    """``replays`` graph replays profiled, after one unprofiled (a wrapper of
    the rollout's graph tells the profiler where each replay ends; batches
    run until the replays are done)."""
    from .. import trace

    graph = ev.rollout.graph

    class Stepped:
        def __init__(self, step):
            self.step = step

        def replay(self):
            graph.replay()
            self.step()

    def one_batch(step):
        ev.rollout.graph = Stepped(step)
        try:
            ev.batch(keep=False)
        finally:
            ev.rollout.graph = graph

    return trace.profile_within(one_batch, replays, host)


def tick_flops(cell, ev):
    """FLOPs of one tick of the whole batch (every row is stepped, live or
    not), counted over the reference on the meta device."""
    from ..flops import count_flops, meta_like
    from ..reference import hcm as ref_hcm

    fam, cfg, B = ev.fam, ev.cfg, ev.B
    w = meta_like(ev.weights)
    sizes = fam.reference_sizes(cell.config, cfg)
    sim = cfg.TASK_CONFIG.SIMULATOR
    H = cfg.MODEL.STATE_ENCODER.hidden_size

    def tick():
        A = ref_hcm.Arith()
        rgb = torch.empty(B, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3, dtype=torch.uint8,
                          device="meta")
        depth = torch.empty(B, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1,
                            dtype=torch.float16, device="meta")
        rgb_f, depth_f = ref_hcm.trunk_features(A, w, rgb, depth)
        emb = torch.empty(B, cell.mix["instruction_len"], cfg.MODEL.BERT.hidden_size,
                          device="meta")
        masks = torch.empty(B, 1, device="meta")
        hidden = torch.empty(2, B, H, device="meta")
        ref_hcm.high_level(A, w, rgb_f, depth_f, emb, masks, hidden, sizes, None)
        ref_hcm.low_level(A, w, rgb_f, depth_f, torch.zeros(B, 1, dtype=torch.long,
                                                            device="meta"), masks, hidden)

    return count_flops(tick)


def check(cell, ev, batches):
    """The numbers compared over a sample of ``batches`` (drawn from the
    seed, the longest among them) followed by the reference; the rollout's
    state is freed first."""
    from ..reference import rollout as ref_rollout

    cfg, mix = ev.cfg, cell.mix
    kept = [b for b in batches if "record" in b]
    rng = random.Random(cell.seed)
    picked = {max(range(len(kept)), key=lambda i: int(kept[i]["n_ticks"]))} if kept else set()
    while len(picked) < min(mix["check_batches"], len(kept)):
        picked.add(rng.randrange(len(kept)))
    sample = [kept[i] for i in sorted(picked)]
    weights, sizes = ev.weights, ev.fam.reference_sizes(cell.config, cfg)
    hw = ((cfg.TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT, cfg.TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH),
          (cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT,
           cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH))
    dt = cfg.DAGGER.time_step
    ev.rollout = ev.recorder = ev.policy = ev.agent = None
    for b in batches:
        if not any(b is x for x in sample):
            b.pop("record", None)
            b.pop("episode", None)
    harness.CARD.release()
    t0 = time.perf_counter()
    readings = [compare(b, ref_rollout.follow(weights, sizes, b["episode"], b["record"],
                                              torch.as_tensor(b["steps"]), hw, dt,
                                              mix["max_steps"]))
                for b in sample]
    numbers = {k: max(r[k] for r in readings) for k in readings[0]} if readings else {}
    return numbers, time.perf_counter() - t0


def compare(batch, ref):
    """The numbers of one followed batch, each the worst over its live
    ticks and rows: logit_gap, action_gap (velocities), stop_gap, the
    absolute gaps of the rollout's outputs from the reference's; pose_gap,
    the rollout's next pose from the reference's integration of its
    actions (metres, and the quaternion's components; after the last tick,
    the position alone); start_gap, the first
    recorded pose from the episode's start; steps_mismatch, the episodes
    whose length differs from the reference's termination."""
    rec, T = batch["record"], ref["ticks"]
    steps = torch.as_tensor(batch["steps"], device=rec["p"].device).long()
    live = torch.arange(T, device=steps.device)[:, None] < steps[None]  # (T, B)

    def worst(a, b):
        gap = (a - b).abs().amax(-1)
        return float(torch.where(live, gap, 0.0).max()) if T else 0.0

    # the pose after tick t is the one recorded before tick t + 1; after the
    # batch's last tick, the rollout's final positions
    final = torch.as_tensor(batch["final_pos"], device=rec["p"].device)[None]
    p_next = torch.cat([rec["p"][1:T], final])
    before_last = torch.arange(T, device=steps.device)[:, None] < T - 1
    q_gap = torch.where(live & before_last, (rec["q"][1:T + 1] - ref["q_next"]).abs().amax(-1),
                        0.0)
    pose = max(worst(p_next, ref["p_next"]), float(q_gap.max()) if T else 0.0)
    ep = batch["episode"]
    start = max(float((rec["p"][0] - ep["start_pos"]).abs().max()),
                float((rec["q"][0] - ep["start_rot"]).abs().max()))
    return {"logit_gap": worst(rec["logits"][:T], ref["logits"]),
            "action_gap": worst(rec["actions"][:T], ref["actions"]),
            "stop_gap": worst(rec["stop"][:T], ref["stop"]),
            "pose_gap": pose, "start_gap": start,
            "steps_mismatch": float((ref["steps"] != steps).sum())}



def compare_references(batch, ref, other):
    """:func:`compare`'s output gaps, and the integrated positions', between
    two followings of one batch (the reference in another precision against
    the float32 one)."""
    T = ref["ticks"]
    steps = torch.as_tensor(batch["steps"], device=ref["logits"].device).long()
    live = torch.arange(T, device=steps.device)[:, None] < steps[None]

    def worst(key):
        gap = (other[key] - ref[key]).abs().amax(-1)
        return float(torch.where(live, gap, 0.0).max()) if T else 0.0

    return {"logit_gap": worst("logits"), "action_gap": worst("actions"),
            "stop_gap": worst("stop"), "pose_gap": worst("p_next")}
