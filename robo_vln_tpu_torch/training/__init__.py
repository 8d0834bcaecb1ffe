"""The train steps (counterpart of robo_vln_tpu/training/steps.py and
optimizers.py), the flat family's and the hierarchical agent's: losses in
ops/losses.py, Adam / AdamW over the trainable parameters, dropout, the
non-finite guard and optional recompute; and the trainers with their
checkpoints (trainer.py's ``robo_vln_trainer``, hierarchical_trainer.py's
``hierarchical_trainer``, checkpoint.py)."""

from . import hierarchical_trainer  # noqa: F401 (registers the trainer)

from .optimizers import (
    FROZEN_MODULE_NAMES,
    adam,
    adamw,
    cyclic_triangular_lr,
    set_lr,
    trainable_mask,
    trainable_parameters,
)
from .steps import (
    HierTrainState,
    TrainState,
    dropout_generator,
    inflection_coef_from,
    make_flat_train_step,
    make_flat_val_step,
    make_hier_train_step,
    make_hier_val_step,
)

__all__ = [
    "FROZEN_MODULE_NAMES",
    "HierTrainState",
    "TrainState",
    "adam",
    "adamw",
    "cyclic_triangular_lr",
    "dropout_generator",
    "inflection_coef_from",
    "make_flat_train_step",
    "make_flat_val_step",
    "make_hier_train_step",
    "make_hier_val_step",
    "set_lr",
    "trainable_mask",
    "trainable_parameters",
]
