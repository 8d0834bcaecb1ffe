"""The hierarchical train step (counterpart of robo_vln_tpu/training/steps.py
and optimizers.py): losses in ops/losses.py, AdamW / Adam over the trainable
parameters, dropout, the non-finite guard and optional recompute; and the
hierarchical trainer with its checkpoints (hierarchical_trainer.py,
checkpoint.py), registered as ``hierarchical_trainer``."""

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
    "make_hier_train_step",
    "make_hier_val_step",
    "set_lr",
    "trainable_mask",
    "trainable_parameters",
]
