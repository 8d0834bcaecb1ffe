"""Diagnostic: open-loop replay of a trained checkpoint on recorded expert
episodes (counterpart of scripts/probe_policy.py).

Feeds the HCM policies the exact observations and previous actions the
expert saw (from the study's training buffer), one tick at a time as the
closed-loop eval steps them, and prints per-step predicted against expert
velocities and predicted against oracle sub-goals.  Distinguishes:

* predictions track the expert on expert states -> the closed-loop failure
  is distribution shift and compounding error (a learning-scale problem);
* predictions are wrong on the expert's own states -> a train/eval
  mechanics mismatch (a framework bug).

Usage: CS_MODEL=hcm python -m robo_vln_tpu_torch.scripts.probe_policy STUDY_OUT_DIR [CKPT_NAME]
(the study's CS_* knobs as the study ran; PROBE_EPISODES, PROBE_PRINT_STEPS).
"""

import os
import sys

import numpy as np
import torch

N_EPISODES = int(os.environ.get("PROBE_EPISODES", 2))
PRINT_STEPS = int(os.environ.get("PROBE_PRINT_STEPS", 24))


def probe(out_dir, ckpt=None):
    """Replay the first PROBE_EPISODES episodes; returns, per episode, the
    open-loop velocity MSE and the high level's (hits, labelled steps)."""
    from robo_vln_tpu_torch.data.loader import TrajectoryDataset
    from robo_vln_tpu_torch.eval import evaluator as ev

    from . import convergence_study as cs

    cs.OUT = out_dir
    cfg = cs.build_config(cs.data_dir())
    trainer = cs.trainer_class()(cfg)
    names = cs.ckpt_names()
    ckpt = ckpt or (names[-1] if names else None)
    assert ckpt, f"no checkpoints under {out_dir}/ckpts"
    trainer._setup_policy()
    ev._load_eval_weights(trainer, os.path.join(out_dir, "ckpts", ckpt))
    high, low, device = trainer.high.eval(), trainer.low.eval(), trainer.device
    trunk_fn = trainer._maybe_trunk_fn()

    ds = TrajectoryDataset(cfg.DAGGER.LMDB_FEATURES_DIR, batch_size=1,
                           is_bert=cfg.MODEL.INSTRUCTION_ENCODER.is_bert,
                           indices=list(range(N_EPISODES)))
    maxlen = cfg.DAGGER.MAX_INSTRUCTION_LEN
    results = []
    for ep_i, (obs_seq, prev_seq, corr_seq, _) in enumerate(ds):
        t_len = len(prev_seq)
        ids = np.zeros((1, maxlen), np.int64)
        row = np.asarray(obs_seq["instruction"]).reshape(-1)  # one row an episode
        ids[0, : min(len(row), maxlen)] = row[:maxlen]
        ids = torch.from_numpy(ids).to(device)
        with torch.no_grad():
            emb = high.embed_instruction(ids)
        hh = high.initial_hidden(1, device)
        lh = low.initial_hidden(1, device)
        oracle = np.asarray(obs_seq["vln_oracle_action_sensor"]).reshape(-1)
        errs, hits, tot = [], 0, 0
        print(f"\n=== episode {ep_i} (T={t_len}) ===")
        print(" t | pred_v pred_w | exp_v exp_w | hl oracle")
        for t in range(t_len):
            obs = {
                "rgb": torch.from_numpy(np.asarray(obs_seq["rgb"][t])[None]).to(device),
                "depth": torch.from_numpy(np.asarray(obs_seq["depth"][t])[None]).to(device),
                "instruction": ids,
                "progress": torch.from_numpy(
                    np.asarray(obs_seq["progress"][t], np.float32).reshape(1, -1)).to(device),
                "instruction_embedding": emb,
            }
            prev = torch.from_numpy(np.asarray(prev_seq[t], np.float32).reshape(1, 2)).to(device)
            mask = torch.tensor([0.0 if t == 0 else 1.0], device=device)
            with torch.no_grad():
                if trunk_fn is not None:
                    obs.update(trunk_fn(obs))
                logits, hh = high(obs, hh, prev, mask)
                pred = logits.argmax(-1)
                actions, _, lh = low(obs, lh, prev, mask, pred)
            a = actions.float().cpu().numpy().reshape(-1)
            e = corr_seq[t]
            hl = int(pred.reshape(-1)[0])
            orc = int(oracle[t]) - 1
            errs.append(((a[0] - e[0]) ** 2 + (a[1] - e[1]) ** 2) / 2)
            if orc >= 0:
                tot += 1
                hits += int(hl == orc)
            if t < PRINT_STEPS or t % 50 == 0 or t >= t_len - 3:
                print(f"{t:3d} | {a[0]: .3f} {a[1]: .3f} | {e[0]: .3f} {e[1]: .3f} | {hl} {orc}")
        print(f"episode {ep_i}: open-loop velocity MSE {np.mean(errs):.4f} "
              f"(first25 {np.mean(errs[:25]):.4f}), "
              f"HL acc {hits}/{tot} = {hits / max(tot, 1):.3f}")
        results.append((float(np.mean(errs)), hits, tot))
    return results


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    probe(argv[0], argv[1] if len(argv) > 1 else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
