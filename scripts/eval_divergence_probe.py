#!/usr/bin/env python3
"""Where chip_smoke.py phase 7b's closed-loop runs part, on one CUDA card.

    python3 scripts/eval_divergence_probe.py

The full-width HCM in float32 evaluates 4 synthetic episodes (chip_smoke's
own, 60 ticks at most, EVAL.NUM_ENVS 4) from a checkpoint of random
weights from seed 0 whose low-level velocity head is scaled by 10, then by
1, and biased by -5 m/s on lin_vel: four runs a scale, with the kernels,
with their plain versions (chip_smoke.plain_kernels), with the kernels
again and plain again.  For each pair of runs it prints the last tick
through which both runs' frames (rgb and depth) are equal, the largest
position gap over every step (EVAL.DUMP_TRAJECTORIES), and at ticks around
that one and every tenth: whether the frames are equal, how far they
differ, and the largest difference of lin_vel, omega, the stop logit and
each level's LSTM state.  Builds the kernels into build/kernels/ first
(about a minute of card time in all).
"""

import contextlib
import math
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from robo_vln_tpu_torch.config import get_config  # noqa: E402
from robo_vln_tpu_torch.ops import _build  # noqa: E402
from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer  # noqa: E402
from robo_vln_tpu_torch.utils.logging import MetricsWriter  # noqa: E402

SCALES = (10.0, 1.0)
BIAS = (-5.0, 0.0)  # lin_vel, omega
MODES = ("kernels", "plain", "kernels", "plain")


def main():
    if not torch.cuda.is_available():
        print("eval_divergence_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.card_line())
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(_build.BUILD_DIR.parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="divergence_", dir=str(_build.BUILD_DIR.parent))
    try:
        data = os.path.join(root, "episodes.json.gz")
        cs.write_eval_episodes(data, cs.EVAL_EPISODES)

        def opts(tag, seed=()):
            return ["DEVICE", str(dev), "TRAINER_NAME", "hierarchical_trainer", *seed,
                    "CHECKPOINT_FOLDER", os.path.join(root, "ckpts_" + tag),
                    "TENSORBOARD_DIR", os.path.join(root, "tb_" + tag),
                    "LOG_FILE", os.path.join(root, "eval.log"),
                    "TASK_CONFIG.SIMULATOR.TYPE", "kinematic",
                    "TASK_CONFIG.DATASET.DATA_PATH", data,
                    "TASK_CONFIG.TASK.NDTW.GT_PATH", os.path.join(root, "no_gt.json.gz"),
                    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", cs.EVAL_MAX_STEPS,
                    "EVAL.EPISODE_COUNT", cs.EVAL_F32_EPISODES,
                    "EVAL.NUM_ENVS", cs.EVAL_F32_EPISODES,
                    "EVAL.VAL_LOG_DIR", os.path.join(root, "val"),
                    "EVAL.DUMP_TRAJECTORIES", True, "MODEL.INSTRUCTION_ENCODER.is_bert", True,
                    "TPU.SYNC_FROZEN_TRUNKS_ON_INIT", True, "TPU.PRECISION", "float32"]

        for scale in SCALES:
            tag = f"scale {scale}"
            saver = HierarchicalTrainer(get_config(opts=opts(tag, ("TASK_CONFIG.SEED", 0))))
            saver._setup_policy()
            with torch.no_grad():
                saver.low.linear.weight.mul_(scale)
                saver.low.linear.bias.add_(torch.tensor(BIAS, device=dev))
            saver.save_checkpoint("ckpt.0")
            del saver
            ckpt = os.path.join(root, "ckpts_" + tag, "ckpt.0")
            trainer = HierarchicalTrainer(get_config(opts=opts(tag)))
            recs, rows = [], []
            for i, mode in enumerate(MODES):
                rec = cs.new_eval_record()
                rec["states"] = []
                with MetricsWriter(os.path.join(root, f"tb_{tag}_{i}")) as writer, \
                        cs.instrumented_eval(rec, dev), \
                        cs.plain_kernels() if mode == "plain" else contextlib.nullcontext():
                    trainer._eval_checkpoint(ckpt, writer, checkpoint_index=i)
                recs.append(rec)
                rows.append(cs.trajectories(writer.log_dir))
                print(f"{tag} {mode}: (steps, success) by episode "
                      f"{ {e: (r['steps'], r['success']) for e, r in sorted(rows[-1].items())} }",
                      flush=True)
            for a, b in ((0, 1), (0, 2), (1, 3), (2, 3)):
                compare(tag, f"{MODES[a]} {a} against {MODES[b]} {b}", recs[a], recs[b],
                        rows[a], rows[b])
            del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


def frames(record):
    return np.stack([np.concatenate([obs[k].reshape(len(obs[k]), -1).astype(np.float32)
                                     for k in ("rgb", "depth")], axis=1)
                     for obs, _ in record["ticks"]])


def compare(tag, label, ra, rb, rows_a, rows_b):
    fa, fb = frames(ra), frames(rb)
    n = min(len(fa), len(fb))
    same = [bool(np.array_equal(fa[t], fb[t])) for t in range(n)]
    first = same.index(False) if False in same else n
    oa, ob = np.stack(ra["outputs"])[:n], np.stack(rb["outputs"])[:n]
    sa, sb = np.stack(ra["states"])[:n], np.stack(rb["states"])[:n]
    d_out = np.abs(oa - ob).reshape(n, -1, 3).max(axis=1)
    d_state = np.abs(sa - sb).reshape(n, 2, 2, -1).max(axis=(2, 3))
    gap = max(math.dist(p, q) for e in rows_a
              for p, q in zip(rows_a[e]["locations"], rows_b[e]["locations"]))
    print(f"{tag} {label}: frames equal through tick {first - 1} of {n}; largest position "
          f"gap {gap:.3e} m")
    for t in sorted(set(range(max(0, first - 2), min(n, first + 4)))
                    | set(range(0, n, 10)) | {n - 1}):
        print(f"   tick {t}: frames equal {same[t]} (largest difference "
              f"{np.abs(fa[t] - fb[t]).max():.3g}, {int((fa[t] != fb[t]).sum())} values "
              f"differ); lin_vel {d_out[t, 0]:.3e}, omega {d_out[t, 1]:.3e}, stop logit "
              f"{d_out[t, 2]:.3e}; high level's state {d_state[t, 0]:.3e}, low level's "
              f"{d_state[t, 1]:.3e}")


if __name__ == "__main__":
    sys.exit(main())
