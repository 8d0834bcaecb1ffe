"""Optimizers and the LR schedule of both trainers (counterpart of
robo_vln_tpu/training/optimizers.py).

* flat policy (RoboVLNTrainer): ``torch.optim.Adam`` at DAGGER.LR, no
  weight decay;
* high level: ``torch.optim.AdamW(weight_decay=wd)``, decoupled decay;
* low level: ``torch.optim.Adam(weight_decay=wd)``, whose decay is L2 added
  to the gradient before the moments, as optax's ``add_decayed_weights``
  before ``scale_by_adam``;
* both with betas (0.9, 0.999) and eps 1e-8, built over the trainable
  parameters only: the frozen backbones are never in a param group, so
  AdamW's decay never reaches them;
* the learning rate is set on the param groups before each step
  (:func:`set_lr`), as the JAX package injects it into the update.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

FROZEN_MODULE_NAMES = ("visual_encoder", "cnn", "embedding_layer")
BETAS = (0.9, 0.999)
EPS = 1e-8


def trainable_mask(module: nn.Module, extra_frozen: tuple = (),
                   unfrozen: tuple = ()) -> Dict[str, bool]:
    """{parameter name: trainable}: False where a component of the name's
    dotted path is a frozen module name.  ``unfrozen`` removes names from
    the frozen set, e.g. ("embedding_layer",) when MODEL.BERT.trainable
    lifts the BERT freeze.  A module that sets ``frozen_by_name = False``
    is not frozen by its own name: the flat family's GloVe table
    (``embedding_layer``) and SimpleCNN (``cnn``) keep the reference's key
    names, where the JAX package's flax parameters (``embedding``,
    ``conv1``...) match no frozen name, and its Adam trains them."""
    frozen = (set(FROZEN_MODULE_NAMES) | set(extra_frozen)) - set(unfrozen)
    exempt = {name for name, m in module.named_modules()
              if getattr(m, "frozen_by_name", True) is False}

    def trainable(name: str) -> bool:
        parts = name.split(".")
        return not any(part in frozen and ".".join(parts[:i + 1]) not in exempt
                       for i, part in enumerate(parts))

    return {name: trainable(name) for name, _ in module.named_parameters()}


def trainable_parameters(module: nn.Module, unfrozen: tuple = ()) -> List[nn.Parameter]:
    mask = trainable_mask(module, unfrozen=unfrozen)
    return [p for name, p in module.named_parameters() if mask[name]]


def adam(module: nn.Module, weight_decay: float = 0.0,
         unfrozen: tuple = ()) -> torch.optim.Adam:
    """torch Adam over the trainable parameters (L2 folded into the
    gradient)."""
    return torch.optim.Adam(trainable_parameters(module, unfrozen), lr=0.0,
                            betas=BETAS, eps=EPS, weight_decay=weight_decay)


def adamw(module: nn.Module, weight_decay: float,
          unfrozen: tuple = ()) -> torch.optim.AdamW:
    """torch AdamW over the trainable parameters (decoupled decay, scaled
    by the learning rate)."""
    return torch.optim.AdamW(trainable_parameters(module, unfrozen), lr=0.0,
                             betas=BETAS, eps=EPS, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def cyclic_triangular_lr(
    step: int,
    base_lr: float = 2e-6,
    max_lr: float = 1e-4,
    step_size_up: int = 1000,
    step_size_down: int = 30000,
) -> float:
    """torch CyclicLR (mode='triangular', cycle_momentum=False) value at
    `step` — stepped by the host once per batch like the reference."""
    cycle_len = step_size_up + step_size_down
    pos = step % cycle_len
    if pos < step_size_up:
        frac = pos / step_size_up
    else:
        frac = 1.0 - (pos - step_size_up) / step_size_down
    return base_lr + (max_lr - base_lr) * frac
