"""Config tree of the PyTorch port: the subtree the HCM agent and its
train step read.

A copy of the keys of robo_vln_tpu/config/default.py that the serving path
and the hierarchical train step of the HCM agent read — ``TPU.*`` switches,
the ``DAGGER.*`` learning rates, the ``MODEL.*`` stanzas of the two policies
and their weight decay — with the same names and defaults, so a config
written for the JAX package sets the same model here.  Keys that only the
port reads are marked "port-only".  ``TPU.DONATE`` is left out: eager
PyTorch updates parameters in place, so there is no buffer to donate.
"""

from typing import List, Optional, Union

from .tree import ConfigTree

_C = ConfigTree()

_C.TPU = ConfigTree()
# compute dtype of the encoders and the attention ("bfloat16" or "float32");
# LayerNorm, GroupNorm statistics, softmax and both kernels stay float32
_C.TPU.PRECISION = "bfloat16"
# run the frozen conv trunks once per step and feed both policies; used only
# when the two policies' trunk weights are bitwise identical
_C.TPU.SHARE_FROZEN_TRUNKS = True
# recompute the train step's forward in its backward
# (torch.utils.checkpoint), trading compute for activation memory
_C.TPU.REMAT = False
# deviation from the reference (off): weight the high level's sub-goal CE by
# MODEL.inflection_weight_coef at sub-goal changes; needs DAGGER.USE_IW too
_C.TPU.APPLY_INFLECTION_WEIGHTS = False
# deviation from the reference (off): mask the velocity MSE by step validity
# instead of zeroing predictions where the target is exactly 0
_C.TPU.VALID_MASK_VELOCITY_MSE = False

_C.DAGGER = ConfigTree()
_C.DAGGER.LR = 1e-4
# the high level's triangular CyclicLR (training/optimizers.cyclic_triangular_lr)
_C.DAGGER.CYCLIC_BASE_LR = 2e-6
_C.DAGGER.CYCLIC_MAX_LR = 1e-4
_C.DAGGER.CYCLIC_STEP_SIZE_UP = 1000
_C.DAGGER.CYCLIC_STEP_SIZE_DOWN = 30000
_C.DAGGER.USE_IW = True

_C.MODEL = ConfigTree()
_C.MODEL.inflection_weight_coef = 3.2
_C.MODEL.ablate_depth = False
_C.MODEL.ablate_rgb = False

_C.MODEL.VISUAL_LING_ATTN = ConfigTree()
_C.MODEL.VISUAL_LING_ATTN.N = 1
_C.MODEL.VISUAL_LING_ATTN.vis_in_features = 256
_C.MODEL.VISUAL_LING_ATTN.ins_in_features = 768
_C.MODEL.VISUAL_LING_ATTN.d_model = 256
_C.MODEL.VISUAL_LING_ATTN.h = 4
_C.MODEL.VISUAL_LING_ATTN.d_ff = 1024
_C.MODEL.VISUAL_LING_ATTN.dropout = 0.25

_C.MODEL.RGB_ENCODER = ConfigTree()
_C.MODEL.RGB_ENCODER.output_size = 256
_C.MODEL.RGB_ENCODER.blocks = [3, 4, 6, 3]  # ResNet50 stage depths

_C.MODEL.DEPTH_ENCODER = ConfigTree()
_C.MODEL.DEPTH_ENCODER.output_size = 128
_C.MODEL.DEPTH_ENCODER.blocks = [3, 4, 6, 3]
# port-only: side of the square depth frame.  It sizes the spatial-embedding
# table and the flattened depth heads, which flax infers from the first input
_C.MODEL.DEPTH_ENCODER.input_size = 256

_C.MODEL.STATE_ENCODER = ConfigTree()
_C.MODEL.STATE_ENCODER.hidden_size = 512
_C.MODEL.STATE_ENCODER.rnn_type = "LSTM"

_C.MODEL.BERT = ConfigTree()
_C.MODEL.BERT.vocab_size = 30522
_C.MODEL.BERT.hidden_size = 768
_C.MODEL.BERT.num_layers = 12
_C.MODEL.BERT.num_heads = 12
_C.MODEL.BERT.intermediate_size = 3072
_C.MODEL.BERT.max_position_embeddings = 512
_C.MODEL.BERT.type_vocab_size = 2
# deviation from the reference (off): train BERT with the policy instead of
# keeping it frozen
_C.MODEL.BERT.trainable = False

_C.MODEL.TRANSFORMER = ConfigTree()
# weight decay of both policies' optimizers (AdamW high, Adam low)
_C.MODEL.TRANSFORMER.weight_decay = 1e-3


def get_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> ConfigTree:
    """defaults <- yaml(s) <- opts, frozen."""
    config = _C.clone()
    if isinstance(config_paths, str):
        config_paths = [config_paths]
    for p in config_paths or []:
        config.merge_from_file(p)
    if opts:
        config.merge_from_list(opts)
    config.freeze()
    return config
