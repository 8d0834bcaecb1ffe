#!/usr/bin/env python3
"""What the DAgger mixer's tick costs beside the eval's tick, on one CUDA card.

    python3 scripts/mixer_tick_probe.py

chip_smoke.py phase 8b finds the mixed collection's policy tick
(envs/dagger.PolicyMixer.step -> HCMAgent.act, B=1) slower than phase 7's
1-env eval tick (eval/evaluator._PolicyTick -> HCMAgent.act) in the same
process.  This probe ticks one full-width bf16 agent (random weights from
seed 0, synced trunks, through a HierarchicalTrainer) on the same 60
observations of one synthetic episode (chip_smoke's writer, the kinematic
backend at 224/256 px) in six ways, each timed by CUDA events around
``act`` and by the host clock around the whole call:

* ``eval``: _PolicyTick, back to back;
* ``mixer``: PolicyMixer.step and set_prev, back to back;
* ``mixer+render``: the same with the env's step (integration, measures
  and the procedural render) on this thread between ticks, as collection
  runs it;
* ``eval+pool``: _PolicyTick with the env's step in envs/async_env's pool
  thread between ticks, as the eval runs it;
* ``mixer+gc_off``: ``mixer+render`` with Python's garbage collector off.

Each way runs twice (in the order above, then reversed), before and after
five train steps on a synthetic batch (B=4, T=50), and prints its median
and quartiles.  Builds the kernels into build/kernels/ first (about two
minutes of card time in all).
"""

import gc
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from robo_vln_tpu_torch.config import get_config  # noqa: E402
from robo_vln_tpu_torch.envs.async_env import AsyncEnvPool  # noqa: E402
from robo_vln_tpu_torch.envs.dagger import mixer_for_trainer  # noqa: E402
from robo_vln_tpu_torch.envs.env_utils import construct_env  # noqa: E402
from robo_vln_tpu_torch.envs.obs_utils import batch_obs, transform_obs  # noqa: E402
from robo_vln_tpu_torch.envs.velocity_control import VelocityControl  # noqa: E402
from robo_vln_tpu_torch.eval import agent as agent_mod  # noqa: E402
from robo_vln_tpu_torch.eval.evaluator import _PolicyTick  # noqa: E402
from robo_vln_tpu_torch.ops import _build  # noqa: E402
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer  # noqa: E402

TICKS = 60
WAYS = ("eval", "mixer", "mixer+render", "eval+pool", "mixer+gc_off")


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return f"median {statistics.median(xs):.3f} (quartiles {q[0]:.3f}-{q[2]:.3f})"


def main():
    if not torch.cuda.is_available():
        print("mixer_tick_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="mixer_probe_", dir=str(_build.BUILD_DIR.parent))
    try:
        data = os.path.join(root, "episodes.json.gz")
        cs.write_eval_episodes(data, 1)
        cfg = get_config(opts=[
            "DEVICE", str(dev), "TRAINER_NAME", "hierarchical_trainer",
            "TASK_CONFIG.SIMULATOR.TYPE", "kinematic", "TASK_CONFIG.DATASET.DATA_PATH", data,
            "MODEL.INSTRUCTION_ENCODER.is_bert", True, "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True,
            "TPU.PRECISION", "bfloat16", "TASK_CONFIG.SEED", 0, "DAGGER.BATCH_SIZE", 4])
        trainer = HierarchicalTrainer(cfg)
        trainer._setup_policy()
        env = construct_env(cfg)
        uuid = cfg.TASK_CONFIG.TASK.INSTRUCTION_SENSOR_UUID
        vc = VelocityControl(np.array([0.0, 0.0, -1.0]), np.array([0.0, 0.2, 0.0]))
        observations = [transform_obs(env.reset(), uuid, is_bert=True)]
        for _ in range(TICKS - 1):
            observations.append(transform_obs(env.step(vc)[0], uuid, is_bert=True))
        keep = ("rgb", "depth", "progress", uuid)
        batched = [batch_obs({k: o[k] for k in keep}, cfg.DAGGER.MAX_INSTRUCTION_LEN)
                   for o in observations]
        pool = AsyncEnvPool([env])

        events = []
        act = agent_mod.HCMAgent.act

        def timed_act(self, *args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = act(self, *args, **kwargs)
            end.record()
            events.append((start, end))
            return out

        agent_mod.HCMAgent.act = timed_act

        def run(way):
            events.clear()
            host = []
            if way.startswith("eval"):
                tick = _PolicyTick(agent_mod.HCMAgent(trainer.high, trainer.low))
                state = tick.agent.initial_state(1)
                for t, obs in enumerate(batched):
                    if way == "eval+pool":
                        pool.async_step([vc])
                        pool.wait_step()
                    t0 = time.perf_counter()
                    _, state = tick(obs, state, [0] if t == 0 else [])
                    host.append((time.perf_counter() - t0) * 1e3)
            else:
                mixer = mixer_for_trainer(trainer)
                if way == "mixer+gc_off":
                    gc.disable()
                try:
                    for obs in observations:
                        if way != "mixer":
                            env.step(vc)
                        t0 = time.perf_counter()
                        v, w = mixer.step(obs)
                        mixer.set_prev(v, w)
                        host.append((time.perf_counter() - t0) * 1e3)
                finally:
                    gc.enable()
                    mixer.close()
            torch.cuda.synchronize()
            device = [s.elapsed_time(e) for s, e in events]
            print(f"  {way:13s} act by CUDA events {quartiles(device)} ms; the call, host "
                  f"{quartiles(host)} ms", flush=True)

        for phase in ("before training", "after five train steps"):
            if phase.startswith("after"):
                gen = torch.Generator().manual_seed(1)
                batch = cs.train_batch(gen, 4, 50, 200, dev)
                for _ in range(5):
                    hh, lh = trainer._initial_hidden()
                    trainer.state, *_ = trainer.train_step(trainer.state, hh, lh, batch,
                                                           1e-6, 1e-6)
                torch.cuda.synchronize()
            print(f"{phase} (trainer batch size {trainer.batch_size}):", flush=True)
            run("eval")  # warm-up, not reported apart from its line
            for way in (*WAYS, *reversed(WAYS)):
                run(way)
        pool.close()
        agent_mod.HCMAgent.act = act
        return 0
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
