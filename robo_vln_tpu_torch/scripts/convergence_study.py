"""LangNav convergence study on the port: closed-loop metrics against
training epochs (counterpart of scripts/convergence_study.py).

Does training improve *navigation* — success / SPL / nDTW in the closed loop —
and does it generalize to held-out instruction compositions?  The study runs
on LangNav (data/langnav.py): a synthetic compositional instruction grammar
whose reference path is derived from the instruction, on the renderless
kinematic backend.  val_seen = training episodes; val_unseen = never-seen
instruction programs from the same grammar.

Pipeline: generate splits -> expert collection -> (feature-store) training
with per-epoch checkpoints -> closed-loop eval of selected checkpoints on
val_seen + val_unseen, the shuffled-instruction control, the host-driver
cross-check and the nonlearning baselines -> a table.

The stages run in this process, one after the other (the JAX script runs
each in a subprocess of its own because of a TPU client's leak, which the
port does not have); CS_STAGE runs one stage alone, as the JAX script's
stage workers do.  Every stage is restartable: collection reuses the
buffer, training resumes from the newest checkpoint (DAGGER.RESUME,
CS_EPOCHS_PER_PROC epochs a ``train()`` call), eval skips checkpoints
already in the per-split jsonl.  The rows, and the traces of
EVAL.DUMP_TRAJECTORIES, are the JAX script's, so scripts/collect_study_results.py
and scripts/eval_parity.py read them unchanged.

Usage:  python -m robo_vln_tpu_torch.scripts.convergence_study [out_dir]
Knobs (env): CS_MODEL=hcm|cma|seq2seq CS_TRAIN=64 CS_VAL=12 CS_EPOCHS=24
  CS_EVAL_EVERY=4 CS_BATCH=8 CS_RGB=224 CS_DEPTH=256 CS_ON_DEVICE=1
  CS_FEATURE_MODE=1 CS_NUM_ENVS=4 CS_SEED=0 CS_EPOCHS_PER_PROC=2
  CS_DEVICE=cuda (the port's own: cpu runs the study without a card)
and the JAX script's others (CS_MAX_STEPS, CS_SEGMENTS, CS_LENGTHS,
CS_NOISE, CS_VALID_MSE, CS_SIMPLE, CS_TRAIN_BERT, CS_BERT_HIDDEN,
CS_BERT_LAYERS, CS_DAGGER_P, CS_DAGGER_ITERS, CS_INSTR_LEN,
CS_HOST_EPISODES).  The frozen backbones are the config's pretrained files
where they exist (utils/pretrained.py), random otherwise; the provenance
rides in every stats json.
"""

import json
import os
import sys
import time

OUT = "/tmp/robo_vln_convergence"  # main() takes it from the command line

# model family: config yaml + trainer kind (hier = HCM two-module pipeline,
# flat = single-policy robo_vln_trainer families)
MODELS = {
    "hcm": ("hierarchical_cma.yaml", "hier"),
    "cma": ("cma_robo.yaml", "flat"),
    "seq2seq": ("seq2seq_robo.yaml", "flat"),
}
MODEL = os.environ.get("CS_MODEL", "hcm")
if MODEL not in MODELS:
    raise SystemExit(f"CS_MODEL must be one of {sorted(MODELS)}, got {MODEL!r}")

N_TRAIN = int(os.environ.get("CS_TRAIN", 64))
N_VAL = int(os.environ.get("CS_VAL", 12))
EPOCHS = int(os.environ.get("CS_EPOCHS", 24))
EVAL_EVERY = int(os.environ.get("CS_EVAL_EVERY", 4))
BATCH = int(os.environ.get("CS_BATCH", 8))
RGB = int(os.environ.get("CS_RGB", 224))
DEPTH = int(os.environ.get("CS_DEPTH", 256))
ON_DEVICE = bool(int(os.environ.get("CS_ON_DEVICE", "1")))
FEATURE_MODE = bool(int(os.environ.get("CS_FEATURE_MODE", "1")))
NUM_ENVS = int(os.environ.get("CS_NUM_ENVS", 4))
SEED = int(os.environ.get("CS_SEED", 0))
MAX_STEPS = int(os.environ.get("CS_MAX_STEPS", 500))
EPOCHS_PER_PROC = int(os.environ.get("CS_EPOCHS_PER_PROC", 2))
DEVICE = os.environ.get("CS_DEVICE", "cuda")
# program shape: turn-dense defaults keep the sub-goal classes balanced
SEGMENTS = tuple(int(x) for x in os.environ.get("CS_SEGMENTS", "2,3,4").split(","))
LENGTHS = tuple(int(x) for x in os.environ.get("CS_LENGTHS", "2,3").split(","))
# two deviations from the reference, on for the study (both off in the
# framework): DART-style noisy collection, and validity-masked velocity MSE
# (the LangNav expert emits exact omega = 0.0 on straights, which the
# reference's zero-target masking drops)
NOISE = float(os.environ.get("CS_NOISE", 0.15))
VALID_MSE = bool(int(os.environ.get("CS_VALID_MSE", "1")))
# NatureCNN-style encoders instead of the frozen ResNet trunks
SIMPLE_CNNS = bool(int(os.environ.get("CS_SIMPLE", "0")))
# MODEL.BERT.trainable, and a smaller trainable BERT (0 = keep the default)
TRAIN_BERT = bool(int(os.environ.get("CS_TRAIN_BERT", "0")))
BERT_HIDDEN = int(os.environ.get("CS_BERT_HIDDEN", "0"))
BERT_LAYERS = int(os.environ.get("CS_BERT_LAYERS", "0"))
# CS_DAGGER_P < 1: the DAgger arm — collection inside train(), CS_DAGGER_ITERS
# iterations of EPOCHS // iters epochs each
DAGGER_P = float(os.environ.get("CS_DAGGER_P", "1.0"))
DAGGER_ITERS = int(os.environ.get("CS_DAGGER_ITERS", "3"))
# checkpoint names are ckpt.{DAGGER.EPOCHS + global_epoch}
EPOCHS_PER_ITER = (max(EPOCHS // DAGGER_ITERS, 1) if DAGGER_P < 1.0 else EPOCHS)
TOTAL_EPOCHS = (EPOCHS_PER_ITER * DAGGER_ITERS if DAGGER_P < 1.0 else EPOCHS)
INSTR_LEN = int(os.environ.get("CS_INSTR_LEN", "200"))
# the host-driver cross-check row runs over the first CS_HOST_EPISODES episodes
HOST_EPISODES = int(os.environ.get("CS_HOST_EPISODES", "4"))


def build_config(data_dir: str):
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.config.default import _CONFIGS

    cfg = get_config(os.path.join(_CONFIGS, MODELS[MODEL][0])).clone().defrost()
    cfg.DEVICE = DEVICE
    tc = cfg.TASK_CONFIG
    tc.SIMULATOR.TYPE = "kinematic"
    tc.DATASET.DATA_PATH = os.path.join(data_dir, "{split}", "{split}.json.gz")
    # dense LangNav ground-truth trajectories (VLN-CE's gt layout): without
    # them nDTW reads about 0 even for perfect rollouts
    gt = os.path.join(data_dir, "{split}", "{split}_gt.json.gz")
    tc.TASK.NDTW.GT_PATH = gt
    tc.TASK.SDTW.GT_PATH = gt
    tc.DATASET.SPLIT = "train"
    tc.ENVIRONMENT.MAX_EPISODE_STEPS = MAX_STEPS
    tc.SIMULATOR.RGB_SENSOR.WIDTH = tc.SIMULATOR.RGB_SENSOR.HEIGHT = RGB
    tc.SIMULATOR.DEPTH_SENSOR.WIDTH = tc.SIMULATOR.DEPTH_SENSOR.HEIGHT = DEPTH
    cfg.MODEL.DEPTH_ENCODER.input_size = DEPTH
    # LangNav paths are 4-12 m: tighten every distance threshold to 1 m
    for node in (tc.TASK, tc.TASK.SUCCESS, tc.TASK.SPL, tc.TASK.NDTW,
                 tc.TASK.SDTW, tc.TASK.ORACLE_SUCCESS, tc.TASK.ORACLE_SPL):
        node.SUCCESS_DISTANCE = 1.0
    tc.TASK.VLN_ORACLE_ACTION_SENSOR.GOAL_RADIUS = 1.0
    tc.SEED = SEED

    d = cfg.DAGGER
    d.UPDATE_SIZE = N_TRAIN
    d.EPOCHS = EPOCHS
    d.BATCH_SIZE = BATCH
    d.EPISODE_LEN_BUCKETS = [100, 200, 300, 400, 500]
    d.PRELOAD_LMDB_FEATURES = True  # collection is a stage of the study
    d.PRELOAD_TRUNK_FEATURES = FEATURE_MODE
    d.LMDB_FEATURES_DIR = os.path.join(OUT, "buffer")
    # no per-epoch val pass: the closed-loop curve is the study's signal
    d.LMDB_EVAL_DIR = os.path.join(OUT, "no_val_buffer")
    d.RESUME = True
    d.MAX_EPOCHS_PER_RUN = EPOCHS_PER_PROC
    # a short CyclicLR ramp: the paper's 1000-step ramp would keep the high
    # level near base_lr for the study's whole step budget
    steps_per_epoch = max(N_TRAIN // BATCH, 1)
    d.CYCLIC_BASE_LR = 1e-5
    d.CYCLIC_MAX_LR = 1e-4
    d.CYCLIC_STEP_SIZE_UP = 2 * steps_per_epoch
    d.CYCLIC_STEP_SIZE_DOWN = max((EPOCHS - 2) * steps_per_epoch, 1)

    d.COLLECT_ACTION_NOISE = NOISE
    d.MAX_INSTRUCTION_LEN = INSTR_LEN
    cfg.TPU.VALID_MASK_VELOCITY_MSE = VALID_MSE
    if DAGGER_P < 1.0:
        d.PRELOAD_LMDB_FEATURES = False
        d.P = DAGGER_P
        d.ITERATIONS = DAGGER_ITERS
        d.EPOCHS = max(EPOCHS // DAGGER_ITERS, 1)
        d.UPDATE_SIZE = N_TRAIN  # per iteration; the buffer aggregates
    if SIMPLE_CNNS:
        cfg.MODEL.DEPTH_ENCODER.cnn_type = "SimpleDepthCNN"
        cfg.MODEL.RGB_ENCODER.cnn_type = "SimpleRGBCNN"
    if TRAIN_BERT:
        cfg.MODEL.BERT.trainable = True
    if BERT_LAYERS > 0:
        cfg.MODEL.BERT.num_layers = BERT_LAYERS
    if BERT_HIDDEN > 0:
        cfg.MODEL.BERT.hidden_size = BERT_HIDDEN
        cfg.MODEL.BERT.num_heads = max(BERT_HIDDEN // 64, 1)
        cfg.MODEL.BERT.intermediate_size = 4 * BERT_HIDDEN
        cfg.MODEL.VISUAL_LING_ATTN.ins_in_features = BERT_HIDDEN
    cfg.TPU.SYNC_FROZEN_TRUNKS_ON_INIT = True
    cfg.CHECKPOINT_FOLDER = os.path.join(OUT, "ckpts")
    cfg.TENSORBOARD_DIR = os.path.join(OUT, "tb")
    cfg.EVAL.VAL_LOG_DIR = os.path.join(OUT, "val")
    cfg.EVAL.USE_CKPT_CONFIG = False  # the study config stays authoritative
    cfg.EVAL.EPISODE_COUNT = N_VAL
    cfg.EVAL.ON_DEVICE = ON_DEVICE
    cfg.EVAL.NUM_ENVS = NUM_ENVS
    cfg.freeze()
    return cfg


def data_dir():
    return os.path.join(OUT, "datasets")


def ckpt_names():
    folder = os.path.join(OUT, "ckpts")
    if not os.path.isdir(folder):
        return []
    out = []
    for name in os.listdir(folder):
        if name.startswith("ckpt."):
            try:
                out.append((int(name.split(".")[1]), name))
            except ValueError:
                continue
    return [n for _, n in sorted(out)]


def pick_checkpoints(names):
    """Every EVAL_EVERY-th checkpoint, anchored at the first and last."""
    picked = names[EVAL_EVERY - 1::EVAL_EVERY]
    if names and (not picked or picked[0] != names[0]):
        picked.insert(0, names[0])
    if names and picked[-1] != names[-1]:
        picked.append(names[-1])
    return picked


def idx_of(ckpt_name: str) -> int:
    """Training epoch (0-based) encoded in 'ckpt.{EPOCHS_PER_ITER+epoch}'."""
    try:
        return int(ckpt_name.split(".")[-1]) - EPOCHS_PER_ITER
    except ValueError:
        return -1


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def stage_collect():
    from robo_vln_tpu_torch.data.trajectory_store import TrajectoryStore
    from robo_vln_tpu_torch.envs.collection import collect_dataset

    cfg = build_config(data_dir())
    buf_dir = cfg.DAGGER.LMDB_FEATURES_DIR
    have = 0
    if os.path.isdir(buf_dir):
        with TrajectoryStore(buf_dir) as s:
            have = len(s)
    if have >= N_TRAIN:  # restartability: collection appends, never redo it
        print(f"[collect] reusing existing buffer ({have} episodes)", flush=True)
        return
    t0 = time.time()
    n = collect_dataset(cfg, buf_dir)
    print(f"[collect] {n} episodes in {time.time() - t0:.1f}s", flush=True)


def trainer_class():
    if MODELS[MODEL][1] == "hier":
        from robo_vln_tpu_torch.training.hierarchical_trainer import HierarchicalTrainer
        return HierarchicalTrainer
    from robo_vln_tpu_torch.training.trainer import RoboVLNTrainer
    return RoboVLNTrainer


def stage_train():
    cfg = build_config(data_dir())
    trainer_class()(cfg).train()


def stage_eval(split: str, shuffled: bool = False, host_check: bool = False,
               tag: str = "", only: str = ""):
    """Evaluate the picked checkpoints on ``split`` into
    convergence_{row split}.jsonl.  ``shuffled``: the grounding control
    (EVAL.SHUFFLE_INSTRUCTIONS); ``host_check``: the final checkpoint on
    the host driver over the first HOST_EPISODES episodes; ``tag``: rows
    under a fresh label; ``only``: one named checkpoint."""
    cfg = build_config(data_dir())
    if MODELS[MODEL][1] == "hier":
        from robo_vln_tpu_torch.eval.evaluator import eval_hierarchical_checkpoint as eval_fn
    else:
        from robo_vln_tpu_torch.eval.evaluator import eval_flat_checkpoint as eval_fn
    from robo_vln_tpu_torch.utils.logging import MetricsWriter

    row_split = f"{split}_shuffled" if shuffled else split
    if host_check:
        row_split += "_host"
    if tag:
        row_split += f"_{tag}"
    rows_path = os.path.join(OUT, f"convergence_{row_split}.jsonl")
    done = set()
    if os.path.exists(rows_path):
        with open(rows_path) as f:
            done = {json.loads(line)["ckpt"] for line in f if line.strip()}

    ecfg = cfg.clone().defrost()
    ecfg.EVAL.SPLIT = split
    ecfg.EVAL.SHUFFLE_INSTRUCTIONS = shuffled
    # per-episode traces -> tb_eval/<row_split>/trajectories.jsonl, which
    # scripts/eval_parity.py reads
    ecfg.EVAL.DUMP_TRAJECTORIES = True
    if host_check:
        ecfg.EVAL.ON_DEVICE = False
        ecfg.EVAL.EPISODE_COUNT = min(HOST_EPISODES, N_VAL)
    ecfg.freeze()
    trainer = trainer_class()(ecfg)
    picked = pick_checkpoints(ckpt_names())
    if only:
        picked = [only]
    elif host_check and picked:
        picked = picked[-1:]  # a parity row, not a curve
    with open(rows_path, "a") as rf:
        for idx, name in enumerate(picked):
            if name in done:
                continue
            t0 = time.time()
            with MetricsWriter(os.path.join(OUT, "tb_eval", row_split)) as w:
                stats = eval_fn(trainer, os.path.join(OUT, "ckpts", name), w, idx)
            row = {
                "model": MODEL,
                "split": row_split,
                "ckpt": name,
                "epoch": idx_of(name),
                "episodes": ecfg.EVAL.EPISODE_COUNT,
                **{k: round(float(v), 4) for k, v in stats.items()
                   if isinstance(v, (int, float))},
                "eval_seconds": round(time.time() - t0, 1),
            }
            rf.write(json.dumps(row) + "\n")
            rf.flush()
            print(f"[eval] {row}", flush=True)


def stage_nonlearning(split: str = "val_unseen", agent: str = "RandomAgent"):
    """The nonlearning agent on the same split and thresholds: the
    RandomAgent is where a grounded policy's shuffled-instruction metrics
    should collapse to, the ExpertAgent what perfect imitation could score."""
    cfg = build_config(data_dir()).clone().defrost()
    cfg.EVAL.SPLIT = split
    cfg.EVAL.EVAL_NONLEARNING = True
    cfg.EVAL.NONLEARNING.AGENT = agent
    cfg.TASK_CONFIG.DATASET.SPLIT = split
    cfg.freeze()
    from robo_vln_tpu_torch.agents.nonlearning import evaluate_agent

    stats = evaluate_agent(cfg)
    row = {
        "model": f"nonlearning_{cfg.EVAL.NONLEARNING.AGENT}",
        "split": split,
        "ckpt": "-",
        "epoch": -1,
        **{k: round(float(v), 4) for k, v in stats.items() if isinstance(v, (int, float))},
    }
    with open(os.path.join(OUT, "convergence_nonlearning.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(f"[nonlearning] {row}", flush=True)


def orchestrate():
    os.makedirs(OUT, exist_ok=True)
    from robo_vln_tpu_torch.data import langnav

    langnav.generate_splits(
        data_dir(), n_train=N_TRAIN, n_val_unseen=N_VAL, n_val_seen=N_VAL,
        seed=SEED, n_segments=SEGMENTS, lengths=LENGTHS,
    )
    print(f"[data] {N_TRAIN} train / {N_VAL} val_seen / {N_VAL} val_unseen "
          f"LangNav episodes -> {data_dir()}", flush=True)

    if DAGGER_P >= 1.0:
        stage_collect()
    # else: the DAgger arm collects inside train()

    t0 = time.time()
    while len(ckpt_names()) < TOTAL_EPOCHS:
        before = len(ckpt_names())
        stage_train()
        if len(ckpt_names()) <= before:
            raise SystemExit(f"train stage made no progress ({before} checkpoints)")
        print(f"[train] {len(ckpt_names())}/{TOTAL_EPOCHS} epochs "
              f"({time.time() - t0:.0f}s elapsed)", flush=True)

    for split in ("val_seen", "val_unseen"):
        stage_eval(split)
    # the language-grounding control: val_unseen with rotated instructions
    stage_eval("val_unseen", shuffled=True)
    if ON_DEVICE:  # the host driver's cross-check of the final checkpoint
        stage_eval("val_unseen", host_check=True)
    stage_nonlearning("val_unseen", "RandomAgent")
    stage_nonlearning("val_unseen", "ExpertAgent")

    rows = []
    for split in ("val_seen", "val_unseen", "val_unseen_shuffled",
                  "val_unseen_host", "nonlearning"):
        path = os.path.join(OUT, f"convergence_{split}.jsonl")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows += [json.loads(line) for line in f if line.strip()]
    with open(os.path.join(OUT, "convergence.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    table = render_table(rows)
    with open(os.path.join(OUT, "convergence.md"), "w") as f:
        f.write(table)
    print(table, flush=True)
    print("CONVERGENCE STUDY OK", flush=True)
    return rows


def render_table(rows) -> str:
    cols = ["success", "spl", "ndtw", "navigation_error", "path_length"]
    out = ["| model | split | epoch | " + " | ".join(cols) + " |",
           "|---|---|---|" + "---|" * len(cols)]
    for r in sorted(rows, key=lambda r: (r["split"], r["epoch"])):
        out.append(
            f"| {r.get('model', MODEL)} | {r['split']} | {r['epoch']} | "
            + " | ".join(str(r.get(c, "—")) for c in cols) + " |"
        )
    return "\n".join(out) + "\n"


def main(argv=None):
    """The whole study, or with CS_STAGE one stage of it, as the JAX
    script's stage workers take it: collect, train, eval (CS_SPLIT,
    CS_SHUFFLE, CS_HOST, CS_ROWS_TAG, CS_ONLY_CKPT) or nonlearning
    (CS_SPLIT, CS_AGENT)."""
    global OUT
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        OUT = argv[0]
    env = os.environ.get
    stage = env("CS_STAGE")
    if stage == "collect":
        stage_collect()
    elif stage == "train":
        stage_train()
    elif stage == "eval":
        stage_eval(env("CS_SPLIT"), bool(int(env("CS_SHUFFLE", "0"))),
                   bool(int(env("CS_HOST", "0"))), env("CS_ROWS_TAG", ""), env("CS_ONLY_CKPT", ""))
    elif stage == "nonlearning":
        stage_nonlearning(env("CS_SPLIT", "val_unseen"), env("CS_AGENT", "RandomAgent"))
    elif stage:
        raise SystemExit(f"unknown CS_STAGE {stage!r}")
    else:
        orchestrate()
    return 0


if __name__ == "__main__":
    sys.exit(main())
