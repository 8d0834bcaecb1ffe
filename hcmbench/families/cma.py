"""The CMA configuration as the benchmark drives it: the port's
``models.CMAPolicy`` under ``training/steps.make_flat_train_step`` with Adam
(``training/optimizers.adam``), the flat trainer's windows, and the reference
that the step is held to."""

from __future__ import annotations

import torch

from ..reference import cma as reference
from ..weights import shapes_of
from .hcm import dtype_of, port_config  # noqa: F401  (the same yaml-over-defaults config)

Reference = reference.Reference
LOSS_KEYS = ("action_loss", "stop_loss")


def dropout_seed(step: int, rank: int):  # CMA draws no dropout
    return None


def modules(cfg):
    from robo_vln_tpu_torch.models import CMAPolicy

    with torch.device("meta"):
        policy = CMAPolicy(cfg.MODEL, num_actions=2, compute_dtype=dtype_of(cfg))
    return (("", policy),)


def weight_shapes(cfg):
    return shapes_of(*modules(cfg))


def tie(weights):
    return weights


class Program:
    def __init__(self, config, cfg, weights, device, mesh=None):
        from robo_vln_tpu_torch.training import optimizers, steps

        ((_, policy),) = modules(cfg)
        self.policy = policy.to_empty(device=device)
        self.policy.load_state_dict(weights)
        if mesh is not None:
            mesh.broadcast(self.policy)
        pm = cfg.MODEL.PROGRESS_MONITOR
        self.step_fn = steps.make_flat_train_step(
            self.policy, use_progress=pm.use, progress_alpha=pm.alpha, remat=cfg.TPU.REMAT,
            valid_velocity_mse=cfg.TPU.VALID_MASK_VELOCITY_MSE, mesh=mesh)
        self.state = steps.TrainState(optimizers.adam(self.policy, 0.0), 0)
        self.lr = config["lr"]
        self.hidden = None

    def run(self, batch):
        if self.hidden is None:
            b = batch["not_done_masks"].shape[0]
            self.hidden = self.policy.initial_hidden(b, batch["not_done_masks"].device)
        self.state, self.hidden, metrics = self.step_fn(self.state, self.hidden, batch, self.lr)
        return {k: metrics[k] for k in LOSS_KEYS}

    def optimizers(self):
        return {"": self.state.optimizer}

    def named_parameters(self):
        return list(self.policy.named_parameters())


def reference_step(ref, batch, config, ranks=1):
    return ref.step(batch, config["lr"], ranks=ranks)


def reference_sizes(config, cfg):
    return {}


def make_batch(gen, mix, cfg, device, rows):
    """One TBPTT window of ``rows`` episodes as the flat trainer reads it:
    frames, instructions of 60 to L GloVe ids then pads, progress, corrected
    velocities in [0, 1), stop targets (u > 0.7), masks 0 at the window's
    first step, every step valid."""
    sim = cfg.TASK_CONFIG.SIMULATOR
    B, T, L = rows, mix["window"], mix["instruction_len"]
    kw = {"generator": gen, "device": device}
    vocab = cfg.MODEL.INSTRUCTION_ENCODER.vocab_size
    ids = torch.randint(1, vocab, (B, L), **kw)
    lengths = torch.randint(min(mix["min_instruction_len"], L), L + 1, (B, 1), **kw)
    ids = torch.where(torch.arange(L, device=device)[None] < lengths, ids, 0)
    masks = torch.ones(B, T, device=device)
    masks[:, 0] = 0.0
    return {
        "rgb": torch.randint(0, 256, (B, T, sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH, 3),
                             dtype=torch.uint8, **kw),
        "depth": torch.rand(B, T, sim.DEPTH_SENSOR.HEIGHT, sim.DEPTH_SENSOR.WIDTH, 1,
                            **kw).half(),
        "instruction": ids,
        "progress": torch.rand(B, T, **kw),
        "prev_actions": torch.zeros(B, T, 2, device=device),
        "corrected_actions": torch.rand(B, T, 2, **kw),
        "oracle_stop": (torch.rand(B, T, 1, **kw) > 0.7).float(),
        "valid_mask": torch.ones(B, T, device=device),
        "not_done_masks": masks,
    }


def kernel_calls(cfg, mix, rows):
    """A step's LSTM kernel calls: the two state encoders, forward and
    backward; the instruction's RNN runs cuDNN and the attentions plain
    PyTorch, so no attention kernel."""
    T, H = mix["window"], cfg.MODEL.STATE_ENCODER.hidden_size
    return {"lstm_forward": [(T, rows, H)] * 2, "lstm_backward": [(T, rows, H)] * 2,
            "attention": []}
