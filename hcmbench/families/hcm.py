"""The HCM configuration as the benchmark drives it: the port's two policies
and its hierarchical train step, the step's batches, and the reference that
the step is held to.

The program: ``training/steps.make_hier_train_step`` over
``models.HighLevelPolicy`` and ``LowLevelPolicy`` with the shared frozen
trunks (``models.make_shared_trunk_fn``), AdamW on the high level and Adam on
the low one (``training/optimizers``), on a ``parallel/mesh.DataMesh`` when
the cell spans several cards.  Its weights come from the harness through
``load_state_dict``.
"""

from __future__ import annotations

import os

import torch

from ..reference import hcm as reference
from ..weights import shapes_of

Reference = reference.Reference
LOSS_KEYS = ("high_level_loss", "low_level_action_loss", "low_level_stop_loss")
DROPOUT_SEED = 17  # the step's dropout masks: seed (17 << 32) + step + (data rank << 24)


def dropout_seed(step: int, rank: int) -> int:
    return (DROPOUT_SEED << 32) + int(step) + (int(rank) << 24)


def port_config(config: dict, device: str, extra=None):
    """The port's config: the configuration's yaml over the defaults, its
    options, then the mix's ``extra`` options."""
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.config.default import _CONFIGS

    opts = ["DEVICE", device]
    for key, value in {**config["options"], **(extra or {})}.items():
        opts += [key, value]
    return get_config(os.path.join(_CONFIGS, config["yaml"]), opts)


def dtype_of(cfg):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.TPU.PRECISION]


def modules(cfg):
    """The policies on the meta device: ((prefix, module), ...)."""
    from robo_vln_tpu_torch.models import HighLevelPolicy, LowLevelPolicy

    with torch.device("meta"):
        high = HighLevelPolicy(cfg.MODEL, num_actions=4, compute_dtype=dtype_of(cfg))
        low = LowLevelPolicy(cfg.MODEL, num_actions=2, num_sub_tasks=4,
                             compute_dtype=dtype_of(cfg))
    return ("high.", high), ("low.", low)


def weight_shapes(cfg):
    return shapes_of(*modules(cfg))


def tie(weights):
    """The low level's frozen trunks are the high level's (the production
    invariant that lets the step run each trunk once)."""
    for name in list(weights):
        if name.startswith(("low.rgb_encoder.cnn.", "low.depth_encoder.visual_encoder.")):
            weights[name] = weights["high." + name[4:]]
    return weights


class Program:
    """The port's step over the harness's weights; ``run(batch)`` is one
    window, the hidden states carried from window to window."""

    def __init__(self, config, cfg, weights, device, mesh=None):
        from robo_vln_tpu_torch.models import make_shared_trunk_fn
        from robo_vln_tpu_torch.ops import cm_attention
        from robo_vln_tpu_torch.training import optimizers, steps

        cm_attention.set_float32_probabilities(cfg.TPU.PALLAS_ATTENTION)
        (_, high), (_, low) = modules(cfg)
        self.levels = {}
        for prefix, m in (("high.", high), ("low.", low)):
            m = m.to_empty(device=device)
            m.load_state_dict({k[len(prefix):]: v for k, v in weights.items()
                               if k.startswith(prefix)})
            self.levels[prefix[:-1]] = m
        high, low = self.levels["high"], self.levels["low"]
        if mesh is not None:
            mesh.broadcast(high, low)
        trunk_fn = make_shared_trunk_fn(high) if cfg.TPU.SHARE_FROZEN_TRUNKS else None
        self.step_fn = steps.make_hier_train_step(
            high, low, trunk_fn=trunk_fn, remat=cfg.TPU.REMAT,
            inflection_coef=steps.inflection_coef_from(cfg),
            valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE, mesh=mesh)
        self.state = steps.HierTrainState(
            steps.TrainState(optimizers.adamw(high, config["weight_decay_high"]), 0),
            steps.TrainState(optimizers.adam(low, config["weight_decay_low"]), 0))
        self.lr = (config["lr_high"], config["lr_low"])
        self.hidden = None

    def run(self, batch):
        if self.hidden is None:
            b = batch["not_done_masks"].shape[0]
            dev = batch["not_done_masks"].device
            self.hidden = (self.levels["high"].initial_hidden(b, dev),
                           self.levels["low"].initial_hidden(b, dev))
        self.state, hh, lh, metrics = self.step_fn(self.state, *self.hidden, batch, *self.lr)
        self.hidden = (hh, lh)
        return {k: metrics[k] for k in LOSS_KEYS}

    def optimizers(self):
        return {"high": self.state.high.optimizer, "low": self.state.low.optimizer}

    def named_parameters(self):
        return [(f"{level}.{n}", p) for level, m in self.levels.items()
                for n, p in m.named_parameters()]


def reference_step(ref, batch, config, ranks=1):
    terms, grads = ref.step(batch, config["lr_high"], config["lr_low"], ranks=ranks)
    return {k: terms[k] for k in LOSS_KEYS}, grads


def reference_sizes(config, cfg):
    return {"attn_heads": cfg.MODEL.VISUAL_LING_ATTN.h,
            "attn_dropout": cfg.MODEL.VISUAL_LING_ATTN.dropout,
            "bert_heads": cfg.MODEL.BERT.num_heads,
            "weight_decay_high": config["weight_decay_high"],
            "weight_decay_low": config["weight_decay_low"]}


def make_batch(gen, mix, cfg, device, rows):
    """One TBPTT window of ``rows`` episodes: frames, BERT ids over the whole
    instruction length, oracle sub-goals in 1-4, corrected velocities in [0,
    1), stop targets (u > 0.7), masks 0 at the window's first step (a new
    episode), every step valid."""
    sim = cfg.TASK_CONFIG.SIMULATOR
    B, T, L = rows, mix["window"], mix["instruction_len"]
    kw = {"generator": gen, "device": device}
    masks = torch.ones(B, T, device=device)
    masks[:, 0] = 0.0
    return {
        "rgb": torch.randint(0, 256, (B, T, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3),
                             dtype=torch.uint8, **kw),
        "depth": torch.rand(B, T, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1,
                            **kw).half(),
        "instruction": torch.randint(1, cfg.MODEL.BERT.vocab_size, (B, L), **kw),
        "vln_oracle_action_sensor": torch.randint(1, 5, (B, T), **kw).float(),
        "prev_actions": torch.zeros(B, T, 2, device=device),
        "corrected_actions": torch.rand(B, T, 2, **kw),
        "oracle_stop": (torch.rand(B, T, 1, **kw) > 0.7).float(),
        "valid_mask": torch.ones(B, T, device=device),
        "not_done_masks": masks,
    }


def kernel_calls(cfg, mix, rows):
    """A step's calls of the hand-written kernels: LSTM (T, B, H), forward
    and backward, one a level; attention (N, Lq, S, h, d, itemsize), the
    high level's block over the rgb (16) and the depth (64) tokens."""
    T, H = mix["window"], cfg.MODEL.STATE_ENCODER.hidden_size
    va = cfg.MODEL.VISUAL_LING_ATTN
    itemsize = 2 if cfg.TPU.PRECISION == "bfloat16" else 4
    depth_tokens = (cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH // 32) ** 2
    attn = [(rows * T, mix["instruction_len"], s, va.h, va.d_model // va.h, itemsize)
            for s in (16, depth_tokens)]
    return {"lstm_forward": [(T, rows, H)] * 2, "lstm_backward": [(T, rows, H)] * 2,
            "attention": attn}


def kernel_calls_tick(cfg, mix, rows, ticks):
    """A graph replay's calls of the hand-written kernels: ``ticks`` ticks,
    each an LSTM call a level at T = 1 and the high level's attention over
    the rgb and the depth tokens."""
    H = cfg.MODEL.STATE_ENCODER.hidden_size
    va = cfg.MODEL.VISUAL_LING_ATTN
    itemsize = 2 if cfg.TPU.PRECISION == "bfloat16" else 4
    depth_tokens = (cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH // 32) ** 2
    attn = [(rows, mix["instruction_len"], s, va.h, va.d_model // va.h, itemsize)
            for s in (16, depth_tokens)]
    return {"lstm_forward": [(1, rows, H)] * 2 * ticks, "lstm_backward": [],
            "attention": attn * ticks}
