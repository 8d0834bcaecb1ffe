"""Config tree of the PyTorch port: the keys its HCM agent, the flat
family's policies, both trainers and the closed-loop eval read, and the keys
the shipped experiment yamls set.

A copy of the keys of robo_vln_tpu/config/default.py with the same names and
defaults, so a config written for the JAX package sets the same model and
the same training loop here: the top-level paths, ``TASK_CONFIG`` (built from
``BASE_TASK_CONFIG_PATH`` as the JAX package builds it), the ``TPU.*``
switches and mesh, the ``DAGGER`` loop, the ``MODEL.*`` stanzas of the two policies,
the pretrained-file keys and the ``EVAL.*`` keys of the host eval loops
and the on-device eval (eval/evaluator.py, eval/ondevice.py).  A key no port code reads yet names the
ROADMAP item (§A) that will read it.  Keys that only the port reads are
marked "port-only".  The JAX package's other keys are not in this tree:
``jax_only.py`` lists them with their JAX defaults, and ``get_config``
refuses one set to another value where the port would drop it, naming the
ROADMAP item that would port it, and
takes any value of those no value of which matters (such as ``TPU.DONATE``:
eager PyTorch updates parameters in place, so there is no buffer to donate).
"""

import importlib.util
import os
from typing import List, Optional, Union

from .jax_only import check_jax_only_keys
from .task import get_task_config
from .tree import ConfigTree

_CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
# the shipped yamls name their task config under the JAX package's config
# directory; the port reads its own byte-identical copy instead
_JAX_CONFIGS = "robo_vln_tpu/config/configs/"

_C = ConfigTree()
_C.BASE_TASK_CONFIG_PATH = ""
_C.TASK_CONFIG = ConfigTree()
_C.CMD_TRAILING_OPTS = []
_C.TRAINER_NAME = "robo_vln_trainer"
# port-only: the device the entry point trains on; "cpu" only when asked for
_C.DEVICE = "cuda"
_C.NUM_PROCESSES = 1  # worker processes of expert collection (envs/collection.py)
_C.TENSORBOARD_DIR = "data/tensorboard_dirs/debug"
_C.CHECKPOINT_FOLDER = "data/checkpoints"
_C.LOG_FILE = "train.log"
# --run-type eval: one checkpoint, or a folder of ckpt.{N} to sweep
_C.EVAL_CKPT_PATH_DIR = "data/checkpoints"
_C.BERT_VOCAB_FILE = ""  # wordpiece vocab for the is_bert instruction path
# the single-env eval's videos (tasks/viz.py): "disk" writes an mp4 an
# episode under VIDEO_DIR, "tensorboard" logs the frames; needs OpenCV
_C.VIDEO_OPTION = []
_C.VIDEO_DIR = "videos/debug"
# the single-env HCM eval's instruction-token salience, a heatmap PNG an
# episode under VIDEO_DIR/attention/ (no OpenCV needed)
_C.PLOT_ATTENTION = False

_C.TPU = ConfigTree()
# the mesh (parallel/mesh.py): one process a rank of the [data, model]
# grid; -1 puts every visible CUDA device on that axis (over the other
# axis; one process on the CPU).  DAGGER.BATCH_SIZE is per data rank.  A
# "model" axis above 1 splits the large 2-D kernels and their Adam moments
# over its ranks (tensor parallelism, parallel/tensor.py)
_C.TPU.MESH_AXES = ["data", "model"]
_C.TPU.MESH_SHAPE = [-1, 1]
# compute dtype of the encoders and the attention ("bfloat16" or "float32");
# LayerNorm, GroupNorm statistics, softmax and both kernels stay float32
_C.TPU.PRECISION = "bfloat16"
# run the frozen conv trunks once per step and feed both policies; used only
# when the two policies' trunk weights are bitwise identical
_C.TPU.SHARE_FROZEN_TRUNKS = True
# copy the high level's frozen trunks into the low level's when the trainer
# sets up random weights (models.sync_frozen_trunks)
_C.TPU.SYNC_FROZEN_TRUNKS_ON_INIT = False
# recompute the train step's forward in its backward
# (torch.utils.checkpoint), trading compute for activation memory
_C.TPU.REMAT = False
# deviation from the reference (off): weight the high level's sub-goal CE by
# MODEL.inflection_weight_coef at sub-goal changes; needs DAGGER.USE_IW too
_C.TPU.APPLY_INFLECTION_WEIGHTS = False
# deviation from the reference (off): mask the velocity MSE by step validity
# instead of zeroing predictions where the target is exactly 0
_C.TPU.VALID_MASK_VELOCITY_MSE = False
# bfloat16 attention's probabilities p before p·v (the JAX package's key, its
# default): off rounds p to bfloat16 once, as XLA's attention does there; on
# keeps p to about 16 bits (p_hi + p_lo), as its Pallas kernel keeps p in
# float32.  The kernel runs either way (ops/cm_attention.set_float32_probabilities)
_C.TPU.PALLAS_ATTENTION = False

# the closed-loop eval (eval/evaluator.py, training/trainer.BaseTrainer.eval)
_C.EVAL = ConfigTree()
_C.EVAL.SPLIT = "val_seen"
# folder-sweep mode: ONCE=True evaluates the checkpoints present and exits;
# ONCE=False is the reference's eval daemon, polling EVAL_CKPT_PATH_DIR for
# NEW checkpoints every POLL_INTERVAL_SEC; POLL_IDLE_TIMEOUT_SEC=0 waits
# forever, >0 exits that long after the last new checkpoint
_C.EVAL.ONCE = True
_C.EVAL.POLL_INTERVAL_SEC = 2.0
_C.EVAL.POLL_IDLE_TIMEOUT_SEC = 0.0
# restore MODEL and DAGGER (and the rest of a port checkpoint's config) from
# the checkpoint evaluated
_C.EVAL.USE_CKPT_CONFIG = True
_C.EVAL.EPISODE_COUNT = 2
# N envs stepped together, one policy tick over the batch; 1 is the
# reference's single-env loop
_C.EVAL.NUM_ENVS = 1
# language-grounding control: every episode carries another episode's
# instruction (evaluator.shuffle_instructions)
_C.EVAL.SHUFFLE_INSTRUCTIONS = False
_C.EVAL.VAL_LOG_DIR = "validation_logging"
# per-episode position traces -> <TENSORBOARD_DIR>/trajectories.jsonl
_C.EVAL.DUMP_TRAJECTORIES = False
# the on-device eval (kinematic backend only, eval/ondevice.py): the whole
# rollout (integration, render, polyline geodesics, policy tick, termination)
# stays on the device, float32, ON_DEVICE_BATCH episodes a batch; on CUDA
# each batch replays a CUDA graph of the tick.  A fast path: its float32 sim
# is not bitwise the host's float64 one
_C.EVAL.ON_DEVICE = False
_C.EVAL.ON_DEVICE_BATCH = 8
# --run-type eval runs a nonlearning agent instead of a trainer
# (agents/nonlearning.py): RandomAgent, HandcraftedAgent or ExpertAgent
_C.EVAL.EVAL_NONLEARNING = False
_C.EVAL.NONLEARNING = ConfigTree()
_C.EVAL.NONLEARNING.AGENT = "RandomAgent"

_C.DAGGER = ConfigTree()
_C.DAGGER.LR = 1e-4
# the high level's triangular CyclicLR (training/optimizers.cyclic_triangular_lr)
_C.DAGGER.CYCLIC_BASE_LR = 2e-6
_C.DAGGER.CYCLIC_MAX_LR = 1e-4
_C.DAGGER.CYCLIC_STEP_SIZE_UP = 1000
_C.DAGGER.CYCLIC_STEP_SIZE_DOWN = 30000
_C.DAGGER.ITERATIONS = 1
_C.DAGGER.EPOCHS = 10
# the batch of one step on the one device (the JAX trainer scales it by its
# mesh's data axis)
_C.DAGGER.BATCH_SIZE = 3
_C.DAGGER.tbptt_steps = 100
_C.DAGGER.USE_IW = True
# DAgger collection (envs/collection.py, envs/dagger.py)
_C.DAGGER.UPDATE_SIZE = 5000
_C.DAGGER.P = 1.0
_C.DAGGER.time_step = 1.0 / 30
_C.DAGGER.COLLECT_DATA_SPLIT = "train"
_C.DAGGER.LMDB_COMMIT_FREQUENCY = 500
_C.DAGGER.COLLECT_ACTION_NOISE = 0.0
# inert in the reference and the JAX package too
_C.DAGGER.LMDB_MAP_SIZE = 2.7e12
_C.DAGGER.LMDB_EVAL_SIZE = 1e11
_C.DAGGER.split_dim = 0
_C.DAGGER.INTER_MODULE_ATTN = False
_C.DAGGER.LMDB_STORE_FREQUENCY = 5
# >1: that many processes decode and collate the batches into shared
# memory (data/parallel_loader.py); the batch order then depends on it
_C.DAGGER.LOADER_WORKERS = 0
# False: each DAgger iteration collects into LMDB_FEATURES_DIR before its
# epochs (envs/collection.py); COLLECT_ONLY stops after the first collection
_C.DAGGER.PRELOAD_LMDB_FEATURES = False
_C.DAGGER.COLLECT_ONLY = False
_C.DAGGER.LMDB_FEATURES_DIR = "data/trajectories_dirs/debug/trajectories.lmdb"
_C.DAGGER.LMDB_EVAL_DIR = "data/trajectories_dirs/debug/trajectories.lmdb"
_C.DAGGER.LOAD_FROM_CKPT = False
_C.DAGGER.CKPT_TO_LOAD = "data/checkpoints/ckpt.0"
# continue from the newest ckpt.{EPOCHS+k} of CHECKPOINT_FOLDER: weights,
# both optimizers' state, the step counters, the LR schedule's position and
# the logging counters, so the resumed run repeats an uninterrupted one
_C.DAGGER.RESUME = False
# stop after this many epochs in this process (0: run to the end)
_C.DAGGER.MAX_EPOCHS_PER_RUN = 0
# train from cached trunk features: each buffer's featurized twin
# <buffer>.features (training/featurize.py), built or refreshed after each
# iteration's collection; the hierarchical trainer needs bitwise-identical
# trunks in both policies, robo_vln_trainer the ResNet encoders (with
# SimpleCNN it warns and trains from raw frames)
_C.DAGGER.PRELOAD_TRUNK_FEATURES = False
# static episode-length buckets the loader pads to
_C.DAGGER.EPISODE_LEN_BUCKETS = [100, 200, 300, 400, 500, 700, 1000]
_C.DAGGER.MAX_INSTRUCTION_LEN = 200

_C.MODEL = ConfigTree()
_C.MODEL.inflection_weight_coef = 3.2
_C.MODEL.ablate_instruction = False
_C.MODEL.ablate_depth = False
_C.MODEL.ablate_rgb = False

# the loader reads is_bert (BERT ids or GloVe ids); the flat family's
# instruction encoders read the rest: is_bert selects Seq2Seq's BERT
# LanguageEncoder, otherwise the GloVe table (read from embedding_file when
# use_pretrained_embeddings and the file exists, else learned) and its RNN
_C.MODEL.INSTRUCTION_ENCODER = ConfigTree()
_C.MODEL.INSTRUCTION_ENCODER.num_layers = 1
_C.MODEL.INSTRUCTION_ENCODER.vocab_size = 2504
_C.MODEL.INSTRUCTION_ENCODER.max_length = 200
_C.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings = True
_C.MODEL.INSTRUCTION_ENCODER.embedding_file = (
    "data/datasets/robo_vln_v1/embeddings.json.gz"
)
_C.MODEL.INSTRUCTION_ENCODER.fine_tune_embeddings = False
_C.MODEL.INSTRUCTION_ENCODER.dataset_vocab = (
    "data/datasets/R2R_VLNCE_v1_preprocessed/train/train.json.gz"
)
_C.MODEL.INSTRUCTION_ENCODER.embedding_size = 50
_C.MODEL.INSTRUCTION_ENCODER.hidden_size = 256
_C.MODEL.INSTRUCTION_ENCODER.rnn_type = "LSTM"
_C.MODEL.INSTRUCTION_ENCODER.final_state_only = True
_C.MODEL.INSTRUCTION_ENCODER.bidirectional = False
_C.MODEL.INSTRUCTION_ENCODER.dropout_ratio = 0.25
_C.MODEL.INSTRUCTION_ENCODER.is_bert = False

_C.MODEL.VISUAL_LING_ATTN = ConfigTree()
_C.MODEL.VISUAL_LING_ATTN.N = 1
_C.MODEL.VISUAL_LING_ATTN.vis_in_features = 256
_C.MODEL.VISUAL_LING_ATTN.ins_in_features = 768
_C.MODEL.VISUAL_LING_ATTN.d_model = 256
_C.MODEL.VISUAL_LING_ATTN.h = 4
_C.MODEL.VISUAL_LING_ATTN.d_ff = 1024
_C.MODEL.VISUAL_LING_ATTN.dropout = 0.25

# pretrained backbone files (.pth or .npz), read by the trainers where they
# exist (utils/pretrained.py); a missing file leaves its backbone random
_C.MODEL.RGB_ENCODER = ConfigTree()
# the flat Seq2Seq's rgb encoder: "SimpleRGBCNN" or the ResNet50
_C.MODEL.RGB_ENCODER.cnn_type = "TorchVisionResNet50"
_C.MODEL.RGB_ENCODER.output_size = 256
_C.MODEL.RGB_ENCODER.blocks = [3, 4, 6, 3]  # ResNet50 stage depths
_C.MODEL.RGB_ENCODER.pretrained_weights = "data/weights/resnet50_imagenet.npz"

_C.MODEL.DEPTH_ENCODER = ConfigTree()
# the flat Seq2Seq's depth encoder: "SimpleDepthCNN" or the ResNet50
_C.MODEL.DEPTH_ENCODER.cnn_type = "VlnResnetDepthEncoder"
_C.MODEL.DEPTH_ENCODER.output_size = 128
_C.MODEL.DEPTH_ENCODER.blocks = [3, 4, 6, 3]
_C.MODEL.DEPTH_ENCODER.ddppo_checkpoint = "data/ddppo-models/gibson-2plus-resnet50.pth"
# port-only: side of the square depth frame.  It sizes the spatial-embedding
# table and the flattened depth heads, which flax infers from the first
# input; get_config sets it from TASK_CONFIG.SIMULATOR.DEPTH_SENSOR
_C.MODEL.DEPTH_ENCODER.input_size = 256

_C.MODEL.STATE_ENCODER = ConfigTree()
_C.MODEL.STATE_ENCODER.hidden_size = 512
_C.MODEL.STATE_ENCODER.rnn_type = "LSTM"

# the flat family (robo_vln_trainer): CMA when CMA.use, else Seq2Seq; each
# may embed the previous action; the progress monitor adds alpha times its
# MSE to the loss; CMA.rcm_state_encoder swaps CMA's first state encoder for
# the RCM recurrent cross-modal attention encoder (models/rcm.py)
_C.MODEL.SEQ2SEQ = ConfigTree()
_C.MODEL.SEQ2SEQ.use_prev_action = False
_C.MODEL.CMA = ConfigTree()
_C.MODEL.CMA.use = False
_C.MODEL.CMA.use_prev_action = False
_C.MODEL.CMA.rcm_state_encoder = False
_C.MODEL.PROGRESS_MONITOR = ConfigTree()
_C.MODEL.PROGRESS_MONITOR.use = False
_C.MODEL.PROGRESS_MONITOR.alpha = 1.0

_C.MODEL.BERT = ConfigTree()
_C.MODEL.BERT.vocab_size = 30522
_C.MODEL.BERT.hidden_size = 768
_C.MODEL.BERT.num_layers = 12
_C.MODEL.BERT.num_heads = 12
_C.MODEL.BERT.intermediate_size = 3072
_C.MODEL.BERT.max_position_embeddings = 512
_C.MODEL.BERT.type_vocab_size = 2
_C.MODEL.BERT.pretrained_weights = "data/weights/bert_base_uncased.npz"
# deviation from the reference (off): train BERT with the policy instead of
# keeping it frozen
_C.MODEL.BERT.trainable = False

_C.MODEL.TRANSFORMER = ConfigTree()
# weight decay of both policies' optimizers (AdamW high, Adam low)
_C.MODEL.TRANSFORMER.weight_decay = 1e-3


def _task_config_path(path: str) -> str:
    """Where the port reads a task config: its own copy of a yaml shipped
    under the JAX package's config directory, any other path as given."""
    if os.path.normpath(path).startswith(os.path.normpath(_JAX_CONFIGS)):
        return os.path.join(_CONFIGS, os.path.relpath(path, _JAX_CONFIGS))
    return path


def depth_input_size(config: ConfigTree) -> int:
    """The side of the square depth frame of TASK_CONFIG's depth sensor,
    which MODEL.DEPTH_ENCODER.input_size must equal."""
    sensor = config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR
    if sensor.WIDTH != sensor.HEIGHT:
        raise ValueError(f"the depth encoder takes a square frame, not "
                         f"{sensor.HEIGHT}x{sensor.WIDTH} (TASK_CONFIG.SIMULATOR.DEPTH_SENSOR)")
    size = config.MODEL.DEPTH_ENCODER.input_size
    if size != sensor.WIDTH:
        raise ValueError(f"MODEL.DEPTH_ENCODER.input_size {size} disagrees with the "
                         f"{sensor.WIDTH} px depth sensor of TASK_CONFIG")
    return size


def check_mesh(config: ConfigTree) -> None:
    """Refuse, before any work, a mesh the port does not build: axis names
    other than ["data", "model"] (the JAX trainers read the mesh's "data"
    axis by name), a shape of another length, or an axis that is neither
    -1 nor a count of ranks, or -1 on both."""
    axes, shape = list(config.TPU.MESH_AXES), list(config.TPU.MESH_SHAPE)
    if axes != ["data", "model"]:
        key, value, why = "TPU.MESH_AXES", axes, "the mesh has the axes ['data', 'model']"
    elif len(shape) != 2 or not all(n == -1 or int(n) >= 1 for n in shape):
        key, value, why = "TPU.MESH_SHAPE", shape, "each axis is -1 or a count of ranks"
    elif shape == [-1, -1]:
        key, value, why = "TPU.MESH_SHAPE", shape, "at most one axis is -1"
    else:
        return
    raise NotImplementedError(f"{key} = {value!r}: {why}")


def check_opencv(config: ConfigTree) -> None:
    """The videos and the top-down map draw with OpenCV, as in the JAX
    package: with cv2 missing, ``VIDEO_OPTION`` set or ``TOP_DOWN_MAP`` among
    the measures raises ImportError here, before any work."""
    wants = []
    if config.VIDEO_OPTION:
        wants.append(f"VIDEO_OPTION {list(config.VIDEO_OPTION)}")
    if "TOP_DOWN_MAP" in config.TASK_CONFIG.TASK.MEASUREMENTS:
        wants.append("TASK_CONFIG.TASK.MEASUREMENTS TOP_DOWN_MAP")
    if wants and importlib.util.find_spec("cv2") is None:
        raise ImportError(f"{' and '.join(wants)} draw with OpenCV (the cv2 module), which "
                          "is not installed")


def get_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> ConfigTree:
    """defaults <- yaml(s) <- opts, frozen; TASK_CONFIG is built from
    BASE_TASK_CONFIG_PATH as the JAX package's get_config builds it.
    MODEL.DEPTH_ENCODER.input_size follows the task's depth sensor; set to
    another size, it raises.  A key of the JAX package that the port does
    not read, set to another value than its JAX default, raises
    NotImplementedError naming its ROADMAP item (jax_only.py); so does a
    mesh the port does not build (:func:`check_mesh`), saying why.  Videos or the
    top-down map without OpenCV raise ImportError (:func:`check_opencv`)."""
    config = _C.clone()
    if isinstance(config_paths, str):
        config_paths = [config_paths]
    for p in config_paths or []:
        config.merge_from_file(p)
    task_path = config.BASE_TASK_CONFIG_PATH
    config.TASK_CONFIG = get_task_config(
        _task_config_path(task_path) if task_path else None).clone().defrost()
    if opts:
        config.CMD_TRAILING_OPTS = list(opts)
        config.merge_from_list(opts)
    depth = config.MODEL.DEPTH_ENCODER
    if depth.input_size == _C.MODEL.DEPTH_ENCODER.input_size:
        depth.input_size = config.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH
    depth_input_size(config)
    check_jax_only_keys(config)
    check_mesh(config)
    check_opencv(config)
    config.freeze()
    return config
