"""The hierarchical (HCM) trainer (counterpart of
robo_vln_tpu/training/hierarchical_trainer.py).

Two policies with two optimizers (AdamW high with the triangular CyclicLR,
Adam low), one optimizer step of each per TBPTT window
(training/steps.make_hier_train_step), the CyclicLR stepped once per outer
batch, a checkpoint per epoch (training/checkpoint.py) and a validation
epoch over the eval buffer with the high level's accuracy.

The batch of a step is ``DAGGER.BATCH_SIZE`` a rank of the data-parallel
mesh (``TPU.MESH_SHAPE``, parallel/mesh.py; one rank on one device unless
it says more), on ``DEVICE`` (CUDA unless the config asks for the CPU);
the loader reads global batches of ``BATCH_SIZE × n_data``, as the JAX
trainer does (BaseTrainer.train, BaseTrainer._batches), each rank
collating only its rows.  A worker thread decodes, collates and copies the
windows one ahead of the step (envs/async_env.window_stream).  Each step's metrics reach the
host in one transfer: the step already synchronises once for its
non-finite guard.

Weights are random from ``TASK_CONFIG.SEED``; the pretrained backbones are
then read into both policies where their files exist (utils/pretrained.py),
before anything (the feature cache's fingerprint, a CUDA graph) sees the
weights, and the provenance of the two merged as the JAX trainer merges it;
``TPU.SYNC_FROZEN_TRUNKS_ON_INIT`` then copies the high level's frozen
trunks into the low level's, so that the shared-trunk pass
(``TPU.SHARE_FROZEN_TRUNKS``) can run: it runs only when the two policies'
trunks are bitwise identical.

With ``DAGGER.PRELOAD_TRUNK_FEATURES``, each iteration trains from the
buffers' featurized twins (training/featurize.py), refreshed after its
collection: the step then skips the frozen trunks and BERT.

With ``DAGGER.PRELOAD_LMDB_FEATURES`` false, each DAgger iteration first
grows the buffer by ``UPDATE_SIZE`` episodes (BaseTrainer._update_dataset):
the expert's rollouts, and past the first iteration with ``DAGGER.P`` < 1
rollouts mixed with the live policy on ``DEVICE`` (envs/dagger.py);
``DAGGER.COLLECT_ONLY`` stops after the first collection.

Options the port does not have yet raise before any work.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config.default import depth_input_size
from ..data.loader import split_tbptt
from ..envs.async_env import device_transfer, window_stream
from ..models import (
    build_hierarchical_policies,
    frozen_trunks_identical,
    make_shared_trunk_fn,
    sync_frozen_trunks,
)
from ..ops import cm_attention
from ..parallel.mesh import DataMesh
from ..utils.device import resolve_device, resolve_dtype
from ..utils.logging import logger
from ..utils.pretrained import graft_pretrained, merge_provenance
from ..utils.registry import register_trainer
from . import checkpoint as ckpt_lib
from . import optimizers as opt_lib
from . import steps as steps_lib
from .trainer import BaseTrainer, host_values

# (metrics key, tag) of each scalar logged per train step and val window,
# under the JAX trainer's tags
TRAIN_SCALARS = (
    ("high_level_loss", "Train High Level Action Loss"),
    ("low_level_action_loss", "Train Low Level Action Loss"),
    ("low_level_stop_loss", "Train Low Level Stop Loss"),
    ("low_level_total_loss", "Train Low_level Total Loss"),
)
VAL_KEYS = ("high_level_loss", "low_level_total_loss", "high_level_accuracy")


@register_trainer("hierarchical_trainer")
class HierarchicalTrainer(BaseTrainer):
    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.DEVICE)
        self.dtype = resolve_dtype(config.TPU.PRECISION)
        depth_input_size(config)
        self.batch_size = config.DAGGER.BATCH_SIZE
        self.features_dir = config.DAGGER.LMDB_FEATURES_DIR.format(
            split=config.TASK_CONFIG.DATASET.SPLIT
        )
        self.eval_dir = config.DAGGER.LMDB_EVAL_DIR
        self.mesh = DataMesh(self.device)
        self.high = None
        self.low = None
        self.state = None
        self.trunk_fn = None
        self._scheduler_step = 0
        self._train_steps = 0
        self._val_steps = 0
        self.pretrained_backbones = {}

    def _setup_policy(self, load_from_ckpt: bool = False, ckpt_path: str = "") -> None:
        cfg = self.config
        # bfloat16 attention's probabilities, as the JAX trainers wire it
        cm_attention.set_float32_probabilities(cfg.TPU.PALLAS_ATTENTION)
        self.high, self.low = build_hierarchical_policies(
            cfg.MODEL, compute_dtype=self.dtype,
            generator=torch.Generator().manual_seed(cfg.TASK_CONFIG.SEED),
        )
        self.pretrained_backbones = merge_provenance(
            graft_pretrained(self.high, cfg.MODEL), graft_pretrained(self.low, cfg.MODEL))
        if cfg.TPU.SYNC_FROZEN_TRUNKS_ON_INIT:
            sync_frozen_trunks(self.high, self.low)
        self.high.to(self.device)
        self.low.to(self.device)
        n_params = sum(p.numel() for m in (self.high, self.low) for p in m.parameters())
        logger.info(f"agent number of parameters: {n_params}")

        wd = cfg.MODEL.TRANSFORMER.weight_decay
        unfrozen = self._unfrozen_names()
        self.state = steps_lib.HierTrainState(
            steps_lib.TrainState(opt_lib.adamw(self.high, wd, unfrozen), 0),
            steps_lib.TrainState(opt_lib.adam(self.low, wd, unfrozen), 0),
        )
        if load_from_ckpt and ckpt_path:
            self.state = ckpt_lib.load_checkpoint(ckpt_path, self.high, self.low, self.state)
            logger.info(f"Loaded weights from checkpoint: {ckpt_path}")

        self.trunk_fn = self._maybe_trunk_fn()
        vvm = cfg.TPU.VALID_MASK_VELOCITY_MSE
        self.train_step = steps_lib.make_hier_train_step(
            self.high, self.low, trunk_fn=self.trunk_fn, remat=cfg.TPU.REMAT,
            inflection_coef=steps_lib.inflection_coef_from(cfg),
            valid_velocity_mse=vvm, mesh=self.mesh,
        )
        self.val_step = steps_lib.make_hier_val_step(
            self.high, self.low, trunk_fn=self.trunk_fn, valid_velocity_mse=vvm,
            mesh=self.mesh,
        )

    def _policies(self):
        return self.high, self.low

    def _restore_loop_state(self, meta) -> None:
        self._scheduler_step = int(meta.get("scheduler_step", 0))

    def _featurized_dirs(self):
        """The feature-store twins of the train and eval buffers
        (DAGGER.PRELOAD_TRUNK_FEATURES, training/featurize.py), built or
        refreshed with the high level's frozen trunks and BERT.  The low
        level then takes the high level's features, so both policies' trunks
        must be bitwise identical, as for the shared trunk pass; where they
        differ, the trainer warns and trains from the raw frames."""
        from .featurize import ensure_featurized

        if not frozen_trunks_identical(self.high, self.low):
            logger.warning("PRELOAD_TRUNK_FEATURES: high/low trunk weights differ; "
                           "training from raw frames")
            return self.features_dir, self.eval_dir
        train_dir = ensure_featurized(self.config, self.high, self.features_dir)
        eval_dir = self.eval_dir
        if os.path.exists(eval_dir):
            eval_dir = ensure_featurized(self.config, self.high, eval_dir)
        return train_dir, eval_dir

    def _maybe_trunk_fn(self):
        """The shared frozen-trunk forward when enabled and safe (both
        policies hold bitwise-identical trunks); checked after any weight
        load."""
        if not self.config.TPU.SHARE_FROZEN_TRUNKS:
            return None
        if not frozen_trunks_identical(self.high, self.low):
            logger.info(
                "frozen trunk weights differ between high/low policies; "
                "trunk sharing disabled (two-pass forward)"
            )
            return None
        logger.info(
            "frozen trunks identical: sharing one ResNet pass per modality "
            "across both policies (TPU.SHARE_FROZEN_TRUNKS)"
        )
        return make_shared_trunk_fn(self.high)

    def _metadata(self):
        return {
            "config": self.config.to_dict(),
            "scheduler_step": int(self._scheduler_step),
            "train_steps": int(self._train_steps),
            "val_steps": int(self._val_steps),
        }

    def save_checkpoint(self, file_name: str) -> None:
        path = os.path.join(self.config.CHECKPOINT_FOLDER, file_name)
        ckpt_lib.save_checkpoint(path, self.high, self.low, self.state,
                                 metadata=self._metadata())

    def _initial_hidden(self):
        b = self.batch_size
        return (self.high.initial_hidden(b, self.device),
                self.low.initial_hidden(b, self.device))

    def train_epoch(self, batches, epoch, writer, train_steps):
        cfg = self.config
        lr_low = cfg.DAGGER.LR
        scheduler_step = self._scheduler_step
        cyc = dict(
            base_lr=cfg.DAGGER.CYCLIC_BASE_LR, max_lr=cfg.DAGGER.CYCLIC_MAX_LR,
            step_size_up=cfg.DAGGER.CYCLIC_STEP_SIZE_UP,
            step_size_down=cfg.DAGGER.CYCLIC_STEP_SIZE_DOWN,
        )
        lr_high = opt_lib.cyclic_triangular_lr(scheduler_step, **cyc)
        send, receive = device_transfer(self.device)
        hh = lh = None
        for is_first, window in window_stream(
            batches, send,
            lambda b: split_tbptt(b, cfg.DAGGER.tbptt_steps), receive,
        ):
            if is_first:
                if hh is not None:
                    scheduler_step += 1  # per outer batch (ref :739)
                    lr_high = opt_lib.cyclic_triangular_lr(scheduler_step, **cyc)
                hh, lh = self._initial_hidden()
            self.state, hh, lh, metrics = self.train_step(
                self.state, hh, lh, window, lr_high, lr_low
            )
            values = host_values(metrics, [k for k, _ in TRAIN_SCALARS])
            for (_, tag), value in zip(TRAIN_SCALARS, values):
                writer.add_scalar(tag, value, train_steps)
            train_steps += 1
        if hh is not None:
            scheduler_step += 1  # the final batch
        self._scheduler_step = scheduler_step
        self._train_steps = train_steps
        self.save_checkpoint(self._epoch_checkpoint(epoch))
        return train_steps

    def val_epoch(self, batches, epoch, writer, val_steps):
        cfg = self.config
        send, receive = device_transfer(self.device)
        high_losses, low_losses, accs = [], [], []
        for batch in batches:
            hh, lh = self._initial_hidden()
            for window in split_tbptt(batch, cfg.DAGGER.tbptt_steps):
                window = send(window)
                if receive is not None:
                    window = receive(window)
                hh, lh, metrics = self.val_step(hh, lh, window)
                high, low, acc = host_values(metrics, VAL_KEYS)
                writer.add_scalar("Val High Level Loss", high, val_steps)
                writer.add_scalar("Val Low Level Loss", low, val_steps)
                val_steps += 1
                high_losses.append(high)
                low_losses.append(low)
                accs.append(acc)
        if high_losses:
            writer.add_scalar(
                "Val High Level Loss Epoch", float(np.mean(high_losses)), epoch
            )
            writer.add_scalar(
                "Val Low Level Loss Epoch", float(np.mean(low_losses)), epoch
            )
            writer.add_scalar(
                "Validation Accuracy", 100.0 * float(np.mean(accs)), epoch
            )
        self._val_steps = val_steps
        return val_steps

    def _eval_checkpoint(self, checkpoint_path, writer, checkpoint_index=0):
        from ..eval.evaluator import eval_hierarchical_checkpoint

        eval_hierarchical_checkpoint(self, checkpoint_path, writer, checkpoint_index)
