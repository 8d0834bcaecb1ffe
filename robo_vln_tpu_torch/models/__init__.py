"""Policy factories and frozen-trunk sharing (counterpart of
robo_vln_tpu/models/__init__.py).

:func:`build_flat_policy` builds the flat family's policy, CMA when
``MODEL.CMA.use`` else Seq2Seq, as the reference's RoboDaggerTrainer
chooses (robo_vln_trainer.py:313-339); :func:`build_hierarchical_policies`
the HCM agent's two.

The reference's high and low policies each own a frozen DDPPO depth ResNet50
and a frozen torchvision ResNet50, loaded from the same weight files.  When
the two copies are bitwise identical (:func:`frozen_trunks_identical`), the
production path (``TPU.SHARE_FROZEN_TRUNKS``) runs each trunk once per step
(:func:`make_shared_trunk_fn`) and feeds both policies the features.  The
trunks run under ``no_grad``: they are frozen, so no graph is recorded
through them (JAX's ``stop_gradient`` lets XLA drop those chains).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .cma import CMAPolicy
from .encoders.bert import BertEncoder
from .encoders.instruction import InstructionEncoder, load_glove_embeddings
from .hierarchical import HighLevelPolicy, LowLevelPolicy
from .rnn_state_encoder import RNNStateEncoder, _RNNWeights
from .seq2seq import Seq2SeqPolicy

_TRUNK_PATHS = ("rgb_encoder.cnn", "depth_encoder.visual_encoder")


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn from ``generator``, in module order: flax's
    defaults (lecun-normal linears and convs, zero biases, N(0, 1) embedding
    tables, orthogonal state-encoder weights, lecun-normal input and
    orthogonal recurrent weights of the instruction RNNs, N(0, 0.02) BERT
    embeddings)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, _RNNWeights):
            nn.init.orthogonal_(m.weight_ih_l0, generator=generator)
            nn.init.orthogonal_(m.weight_hh_l0, generator=generator)
            m.bias_ih_l0.zero_()
            m.bias_hh_l0.zero_()
        elif isinstance(m, nn.RNNBase):
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
                elif name.startswith("weight_hh"):
                    nn.init.orthogonal_(p, generator=generator)
                else:
                    p.zero_()
    for m in module.modules():
        if isinstance(m, BertEncoder):
            for emb in m.embeddings.children():
                if isinstance(emb, nn.Embedding):
                    emb.weight.normal_(0.0, 0.02, generator=generator)


def build_hierarchical_policies(model_config, num_sub_tasks: int = 4,
                                compute_dtype=torch.float32,
                                generator: torch.Generator = None):
    """(HighLevelPolicy, LowLevelPolicy) on the CPU, in eval mode, with
    random weights from ``generator`` (a fresh one seeded 0 if None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    high = HighLevelPolicy(model_config, num_actions=num_sub_tasks,
                           compute_dtype=compute_dtype)
    low = LowLevelPolicy(model_config, num_actions=2, num_sub_tasks=num_sub_tasks,
                         compute_dtype=compute_dtype)
    init_weights(high, generator)
    init_weights(low, generator)
    return high.eval(), low.eval()


def build_flat_policy(model_config, num_actions: int = 2, num_sub_tasks: int = 4,
                      compute_dtype=torch.float32, generator: torch.Generator = None,
                      rgb_hw=(224, 224)):
    """CMAPolicy when MODEL.CMA.use, else Seq2SeqPolicy, on the CPU, in
    eval mode, with random weights from ``generator`` (a fresh one seeded 0
    if None); the GloVe instruction table is read from
    INSTRUCTION_ENCODER.embedding_file when use_pretrained_embeddings and
    the file exists, as the flax initialiser reads it.  ``rgb_hw``: the rgb
    frame's (height, width), which sizes SimpleRGBCNN's Linear."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if model_config.CMA.use:
        policy = CMAPolicy(model_config, num_actions=num_actions, compute_dtype=compute_dtype)
    else:
        policy = Seq2SeqPolicy(model_config, num_actions=num_actions,
                               num_sub_tasks=num_sub_tasks, compute_dtype=compute_dtype,
                               rgb_hw=rgb_hw)
    init_weights(policy, generator)
    ic = model_config.INSTRUCTION_ENCODER
    if isinstance(policy.instruction_encoder, InstructionEncoder) and \
            ic.use_pretrained_embeddings:
        table = load_glove_embeddings(ic.embedding_file)
        if table is not None:
            policy.instruction_encoder.load_table(table)
    return policy.eval()


def _trunk_state(policy: nn.Module, path: str):
    return policy.get_submodule(path).state_dict()


def frozen_trunks_identical(high: nn.Module, low: nn.Module) -> bool:
    """True iff both policies hold bitwise-identical frozen trunks (weights
    and BatchNorm statistics): the precondition for sharing the trunk pass."""
    for path in _TRUNK_PATHS:
        a, b = _trunk_state(high, path), _trunk_state(low, path)
        if a.keys() != b.keys():
            return False
        if not all(a[k].shape == b[k].shape and torch.equal(a[k], b[k]) for k in a):
            return False
    return True


@torch.no_grad()
def sync_frozen_trunks(high: nn.Module, low: nn.Module) -> None:
    """Copy the high level's frozen trunks into the low level's (copies, not
    aliases): the production invariant, for randomly initialised policies."""
    for path in _TRUNK_PATHS:
        low.get_submodule(path).load_state_dict(_trunk_state(high, path))


def make_shared_trunk_fn(high: HighLevelPolicy):
    """observations -> {"rgb_features", "depth_features"}, each trunk run
    once with the high level's weights; both policies then take the features
    through their encoders' ``*_features`` path.  Accepts (B, T, H, W, C) or
    (B, H, W, C) frames and returns features with the same leading shape,
    laid out (…, h, w, C), computed under ``no_grad``."""
    tv = high.rgb_encoder.cnn
    gn = high.depth_encoder.visual_encoder
    dt = high.compute_dtype

    @torch.no_grad()
    def trunk_fn(observations):
        rgb, depth = observations["rgb"], observations["depth"]
        lead = rgb.shape[:-3]
        rgb = rgb.reshape((-1,) + tuple(rgb.shape[-3:]))
        depth = depth.reshape((-1,) + tuple(depth.shape[-3:]))
        rgb_map = tv((rgb.to(dt) / 255.0).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        depth_map = gn(depth.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return {
            "rgb_features": rgb_map.reshape(lead + rgb_map.shape[1:]),
            "depth_features": depth_map.reshape(lead + depth_map.shape[1:]),
        }

    return trunk_fn


__all__ = [
    "CMAPolicy",
    "HighLevelPolicy",
    "LowLevelPolicy",
    "RNNStateEncoder",
    "Seq2SeqPolicy",
    "build_flat_policy",
    "build_hierarchical_policies",
    "frozen_trunks_identical",
    "init_weights",
    "make_shared_trunk_fn",
    "sync_frozen_trunks",
]
