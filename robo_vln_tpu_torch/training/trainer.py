"""The trainers' shared loop logic and the flat family's trainer
(counterpart of robo_vln_tpu/training/trainer.py).

Epoch bookkeeping is plain Python and follows the JAX package line for
line: where a resumed run starts (:meth:`BaseTrainer._find_resume`), which
epochs each DAgger iteration trains (:meth:`BaseTrainer._iteration_plan`,
global epoch numbers, so checkpoint names ``ckpt.{EPOCHS+epoch}`` stay
monotonic), and the batches of one epoch (:meth:`BaseTrainer._batches`,
seeded by the epoch, so a resumed run reads what an uninterrupted one
reads), the eval's checkpoint sweep and daemon (:meth:`BaseTrainer.eval`,
each checkpoint through the subclass's ``_eval_checkpoint``), and DAgger
collection into the buffer (:meth:`BaseTrainer._update_dataset`, envs/).

:class:`RoboVLNTrainer` (``robo_vln_trainer``) is the flat family's: the
collection configs (robovln_data_{train,val}.yaml) collect the expert's
buffer, and cma_robo.yaml, seq2seq_robo.yaml and seq2seq_robo_pm.yaml train
CMA or Seq2Seq from it (the reference's RoboDaggerTrainer,
robo_vln_trainer.py:294-954): Adam at DAGGER.LR, one step a TBPTT window
(training/steps.make_flat_train_step), a checkpoint an epoch, a validation
epoch over the eval buffer, and ``--run-type eval``
(eval/evaluator.eval_flat_checkpoint).  Both trainers train over the
``[data, model]`` grid of ``TPU.MESH_SHAPE`` (parallel/mesh.py, joined in
:meth:`BaseTrainer._join_mesh`): ``DAGGER.BATCH_SIZE`` a data rank, a
global batch of ``BATCH_SIZE × n_data`` read through the in-process loader
or, with ``DAGGER.LOADER_WORKERS > 1``, the process-parallel one
(data/parallel_loader.py), each rank collating and stepping on its data
rank's rows of it; on a "model" axis above 1 each rank holds its slices of
the large kernels and of their Adam moments
(:meth:`BaseTrainer._shard_policies`); rank 0 alone collects, featurizes
(on whole copies of the policies, :meth:`BaseTrainer._whole_policies`),
writes checkpoints (gathered whole by every rank) and TensorBoard.  With
``DAGGER.PRELOAD_TRUNK_FEATURES`` it trains and validates from the
buffers' featurized twins (training/featurize.py, the policy's frozen
ResNet trunks run once a buffer), as the JAX flat trainer does; with a
SimpleCNN encoder it warns and trains from raw frames.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch

from ..config.default import depth_input_size
from ..data.loader import TrajectoryDataset, batch_iterator, split_tbptt
from ..data.trajectory_store import TrajectoryStore
from ..envs.async_env import device_transfer, window_stream
from ..models import build_flat_policy
from ..ops import cm_attention
from ..parallel import tensor as tensor_lib
from ..parallel.mesh import DataMesh, global_batch_size, shard_params
from ..utils.device import resolve_device, resolve_dtype
from ..utils.logging import MetricsWriter, logger
from ..utils.pretrained import graft_pretrained
from ..utils.registry import register_trainer
from . import checkpoint as ckpt_lib
from . import optimizers as opt_lib
from . import steps as steps_lib

def host_values(metrics, keys):
    """The metrics named by ``keys`` as floats, in one device-to-host copy."""
    return torch.stack([metrics[k].float() for k in keys]).tolist()


class _NoWriter:
    """The metrics writer of a rank other than 0: rank 0 logs the global
    batch's metrics, which every rank holds."""

    def add_scalar(self, tag, value, step) -> None:
        pass


class BaseTrainer:
    """Subclasses set ``config``, ``device``, ``batch_size`` (a data
    rank's), ``mesh`` (the one-rank mesh until train() joins
    TPU.MESH_SHAPE's) and ``POLICIES``, the names of their policy
    attributes."""

    POLICIES: tuple = ()

    @property
    def global_batch(self) -> int:
        return global_batch_size(self.batch_size, self.mesh.size)

    def _policies(self):
        return tuple(getattr(self, name) for name in self.POLICIES)

    def _join_mesh(self) -> None:
        """The mesh of TPU.MESH_SHAPE over the process group that is up
        (one rank without one)."""
        self.mesh = DataMesh.for_config(self.config, self.device)
        logger.info(f"training mesh: {self.mesh.size} x {self.mesh.model_size} ranks "
                    f"(data x model), DAGGER.BATCH_SIZE={self.batch_size} a data rank, "
                    f"global batch {self.global_batch}")

    def _shard_policies(self) -> None:
        """On a "model" axis above 1: every rank keeps its slices of the
        kernels param_shardings splits (JAX's rule at its default
        min_size), and of the moments its optimizers already hold (a
        resumed run's).  After the broadcast, so the slices are of rank 0's
        weights."""
        if self.mesh.model_size == 1:
            return
        split = whole = 0
        for policy, optimizer in zip(self._policies(), self._optimizers()):
            plan = shard_params(policy, self.mesh)
            tensor_lib.shard_optimizer(optimizer, policy)
            split += sum(dim is not None for dim in plan.values())
            whole += sum(p.numel() for p in policy.parameters())
        logger.info(f"model axis of {self.mesh.model_size}: {split} tensors split, "
                    f"{whole} parameter elements on each rank")

    @contextlib.contextmanager
    def _whole_policies(self):
        """Around rank 0's own work (collection, featurizing): the
        policies as whole copies, gathered over the model axis by every rank
        (a split policy run by rank 0 alone would wait in its first
        collective), then the split ones back."""
        split = self._policies()
        if self.mesh.model_size == 1 or any(m is None for m in split):
            yield
            return
        for name, m in zip(self.POLICIES, split):
            setattr(self, name, tensor_lib.whole_copy(m))
        try:
            yield
        finally:
            for name, m in zip(self.POLICIES, split):
                setattr(self, name, m)

    def _writer(self):
        return (MetricsWriter(self.config.TENSORBOARD_DIR) if self.mesh.is_main
                else contextlib.nullcontext(_NoWriter()))

    def _unfrozen_names(self) -> tuple:
        """Backbone subtrees lifted out of the frozen set by explicit
        deviation flags: MODEL.BERT.trainable unfreezes the instruction
        embedding; it cannot combine with the feature store, which caches
        BERT outputs as constants."""
        cfg = self.config
        if not cfg.MODEL.BERT.trainable:
            return ()
        if cfg.DAGGER.PRELOAD_TRUNK_FEATURES:
            raise ValueError(
                "MODEL.BERT.trainable=True is incompatible with "
                "DAGGER.PRELOAD_TRUNK_FEATURES: the feature store caches the "
                "frozen BERT instruction embeddings"
            )
        return ("embedding_layer",)

    def _epoch_checkpoint(self, epoch: int) -> str:
        """The per-epoch name, ckpt.{EPOCHS+epoch} (the reference's scheme)."""
        return f"ckpt.{self.config.DAGGER.EPOCHS + epoch}"

    def _find_resume(self):
        """DAGGER.RESUME: the newest per-epoch checkpoint in
        CHECKPOINT_FOLDER and the loop counters it recorded, as
        (next_epoch, ckpt_path, metadata); (0, "", {}) when starting
        fresh."""
        cfg = self.config
        ckpts = ckpt_lib.list_checkpoints(cfg.CHECKPOINT_FOLDER)
        if not ckpts:
            return 0, "", {}
        latest = ckpts[-1]
        try:
            # per-epoch names are ckpt.{EPOCHS+epoch} (reference scheme)
            epoch_done = int(os.path.basename(latest).split(".")[-1])
            epoch_done -= cfg.DAGGER.EPOCHS
        except ValueError:
            return 0, "", {}
        if epoch_done < 0:
            return 0, "", {}
        meta = ckpt_lib.load_metadata(latest) or {}
        return epoch_done + 1, latest, meta

    def _iteration_plan(self, start_epoch: int):
        """(dagger_it, epoch_range) schedule with global epoch numbering:
        iteration k trains epochs [k*EPOCHS, (k+1)*EPOCHS).
        MAX_EPOCHS_PER_RUN bounds the per-process total across iterations;
        a resumed run (global start_epoch) skips fully trained iterations."""
        cfg = self.config
        per = cfg.DAGGER.EPOCHS
        budget = cfg.DAGGER.MAX_EPOCHS_PER_RUN
        if budget <= 0:
            budget = per * cfg.DAGGER.ITERATIONS
        plan = []
        for k in range(cfg.DAGGER.ITERATIONS):
            begin = max(k * per, start_epoch)
            end = min((k + 1) * per, begin + budget)
            if begin >= end:
                continue  # this iteration is already fully trained
            budget -= end - begin
            plan.append((k, range(begin, end)))
            if budget <= 0:
                break
        return plan

    @property
    def _total_epochs(self) -> int:
        return self.config.DAGGER.EPOCHS * self.config.DAGGER.ITERATIONS

    def _batches(self, features_dir: str, seed: int) -> Iterator[Dict]:
        """This rank's rows of the static-shape global batches of one
        epoch, in the order ``seed`` gives: the in-process loader, or with
        DAGGER.LOADER_WORKERS > 1 the process-parallel one (its own order
        for a given worker count, as in JAX).  Every rank decodes every
        episode, for the order and each batch's bucket, and collates only
        its rows."""
        cfg = self.config
        decode = dict(is_bert=cfg.MODEL.INSTRUCTION_ENCODER.is_bert, use_iw=cfg.DAGGER.USE_IW,
                      inflection_weight_coef=cfg.MODEL.inflection_weight_coef)
        buckets = list(cfg.DAGGER.EPISODE_LEN_BUCKETS)
        rows = self.mesh.rows(self.global_batch)
        if int(cfg.DAGGER.LOADER_WORKERS) > 1:
            from ..data.parallel_loader import parallel_batch_iterator

            return parallel_batch_iterator(
                features_dir, self.global_batch, buckets, cfg.DAGGER.MAX_INSTRUCTION_LEN,
                num_workers=int(cfg.DAGGER.LOADER_WORKERS), seed=seed, rows=rows, **decode)
        dataset = TrajectoryDataset(features_dir, batch_size=self.global_batch, seed=seed,
                                    **decode)
        return batch_iterator(dataset, self.global_batch, buckets,
                              cfg.DAGGER.MAX_INSTRUCTION_LEN, rows=rows)

    # -- collection (host-side; see envs/) -------------------------------------
    def _update_dataset(self, data_it: int) -> None:
        """Grow the buffer to (data_it+1)*UPDATE_SIZE episodes.  Restartable:
        episodes already in the buffer count toward the target, so a resumed
        run never collects an iteration twice (the reference instead WIPES
        the lmdb buffer on every collect run, robo_vln_trainer.py:834-837)."""
        from ..envs.collection import collect_dataset

        target = (data_it + 1) * self.config.DAGGER.UPDATE_SIZE
        have = 0
        if os.path.isdir(self.features_dir):
            with TrajectoryStore(self.features_dir) as store:
                have = len(store)
        if have >= target:
            logger.info(
                f"collection iteration {data_it}: buffer already holds "
                f"{have} episodes (target {target}); skipping"
            )
            return
        mixer, beta = self._collection_mixer(data_it)
        try:
            collect_dataset(self.config, self.features_dir, mixer=mixer,
                            beta=beta, update_size=target - have)
        finally:
            if mixer is not None:
                mixer.close()

    def _collection_beta(self, data_it: int) -> float:
        """beta = P**data_it for DAGGER.P < 1, else 1 (VLN-CE semantics; the
        reference exposes P but never mixes, robo_vln_trainer.py:387-503).
        data_it counts LOAD_FROM_CKPT as one prior iteration, mirroring the
        reference's dagger_it offset (robo_vln_trainer.py:898-900)."""
        p = float(self.config.DAGGER.P)
        if self.config.DAGGER.LOAD_FROM_CKPT:
            data_it += 1
        return p ** data_it if p < 1.0 else 1.0

    def _collection_mixer(self, data_it: int):
        """(mixer, beta) for collection iteration ``data_it``: no mixer at
        beta 1; else the policy (set up first if need be) mixed in through
        envs/dagger.py on the trainer's device."""
        beta = self._collection_beta(data_it)
        if beta >= 1.0:
            return None, 1.0
        if getattr(self, "policy", None) is None and \
                getattr(self, "high", None) is None:
            self._setup_policy(
                self.config.DAGGER.LOAD_FROM_CKPT,
                self.config.DAGGER.CKPT_TO_LOAD,
            )
        from ..envs.dagger import mixer_for_trainer

        logger.info(
            f"DAgger mixed collection: beta={beta:.4f} "
            f"(P={self.config.DAGGER.P}, data_it={data_it})"
        )
        return mixer_for_trainer(self), beta

    def _restore_loop_state(self, meta: Dict) -> None:
        """Loop state a resumed run takes from its checkpoint's metadata,
        beyond the step counters (the hierarchical trainer's CyclicLR)."""

    def train(self) -> None:
        """DAgger iterations of collection (PRELOAD_LMDB_FEATURES false)
        and epochs, each epoch a checkpoint and, where the eval buffer
        exists, a validation; DAGGER.RESUME continues from the newest
        checkpoint.  Over the mesh every rank steps on its rows of each
        global batch, from rank 0's weights; rank 0 alone collects,
        featurizes, writes checkpoints and TensorBoard."""
        cfg = self.config
        self._unfrozen_names()  # MODEL.BERT.trainable with the feature store raises
        self._join_mesh()
        collect = not cfg.DAGGER.PRELOAD_LMDB_FEATURES
        if collect and cfg.DAGGER.COLLECT_ONLY:
            # reference behavior: collect then stop (robo_vln_trainer.py:903)
            self.mesh.on_main(self._update_dataset, 0)
            logger.info("Data collection complete")
            return
        start_epoch, resume_ckpt, resume_meta = (
            self._find_resume() if cfg.DAGGER.RESUME else (0, "", {})
        )
        if resume_ckpt:
            self._setup_policy(True, resume_ckpt)
            self._restore_loop_state(resume_meta)
            logger.info(f"resuming at epoch {start_epoch} from {resume_ckpt}")
        else:
            self._setup_policy(cfg.DAGGER.LOAD_FROM_CKPT, cfg.DAGGER.CKPT_TO_LOAD)
        # every rank from rank 0's weights: the same seed built the same ones,
        # and a resumed checkpoint is the same file on every rank
        self.mesh.broadcast(*self._policies())
        self._shard_policies()
        if self.mesh.is_main:
            os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        with self._writer() as writer:
            train_steps = int(resume_meta.get("train_steps", 0))
            val_steps = int(resume_meta.get("val_steps", 0))
            self._train_steps, self._val_steps = train_steps, val_steps
            done_through = start_epoch
            for dagger_it, epochs in self._iteration_plan(start_epoch):
                if collect:
                    with self._whole_policies():
                        self.mesh.on_main(self._update_dataset, dagger_it)
                    logger.info(f"Data collection complete (iteration {dagger_it})")
                train_dir, eval_dir = self.features_dir, self.eval_dir
                if cfg.DAGGER.PRELOAD_TRUNK_FEATURES:
                    # after the collection, so that a buffer that has just
                    # grown is featurized up to its new end
                    with self._whole_policies():
                        train_dir, eval_dir = self.mesh.on_main(self._featurized_dirs)
                for epoch in epochs:
                    t0 = time.time()
                    train_steps = self.train_epoch(
                        self._batches(train_dir, seed=epoch),
                        epoch, writer, train_steps,
                    )
                    if os.path.exists(eval_dir):
                        val_steps = self.val_epoch(
                            self._batches(eval_dir, seed=epoch),
                            epoch, writer, val_steps,
                        )
                        # the epoch's checkpoint was saved before its
                        # validation: record the validation's counter too,
                        # so a resumed run logs where this one would have
                        ckpt_lib.write_metadata(
                            os.path.join(cfg.CHECKPOINT_FOLDER,
                                         self._epoch_checkpoint(epoch)),
                            self._metadata())
                    logger.info(f"epoch {epoch} done in {time.time() - t0:.1f}s "
                                f"({train_steps} train steps)")
                done_through = epochs.stop
            if done_through < self._total_epochs:
                logger.info(
                    f"stopping after epoch {done_through - 1} "
                    "(DAGGER.MAX_EPOCHS_PER_RUN); a DAGGER.RESUME run "
                    f"continues at epoch {done_through}"
                )
        self.mesh.barrier()  # no rank leaves before rank 0's last checkpoint

    def eval(self) -> None:
        """Evaluate EVAL_CKPT_PATH_DIR: a single checkpoint, or a folder
        sweep.  With EVAL.ONCE=False the sweep becomes the reference's eval
        daemon: it polls the folder every EVAL.POLL_INTERVAL_SEC for NEW
        checkpoints, so eval runs beside training and picks up each epoch's
        checkpoint as it lands, and retries a checkpoint that fails (it may
        be listed mid-save) on the next poll; EVAL.POLL_IDLE_TIMEOUT_SEC
        bounds how long it waits after the last new checkpoint (0 =
        forever, the reference behavior).  EVAL.ONCE=True (default) lists
        the folder once and exits."""
        path = self.config.EVAL_CKPT_PATH_DIR
        once = bool(self.config.EVAL.ONCE)
        interval = float(self.config.EVAL.POLL_INTERVAL_SEC)
        idle_timeout = float(self.config.EVAL.POLL_IDLE_TIMEOUT_SEC)
        with MetricsWriter(self.config.TENSORBOARD_DIR) as writer:
            if not (os.path.isdir(path) and not os.path.exists(
                os.path.join(path, ckpt_lib.METADATA)
            )):
                self._eval_checkpoint(path, writer, checkpoint_index=0)
                return
            evaluated = set()
            index = 0
            last_new = time.time()
            while True:
                fresh = [c for c in ckpt_lib.list_checkpoints(path)
                         if c not in evaluated]
                for ck in fresh:
                    try:
                        self._eval_checkpoint(ck, writer, checkpoint_index=index)
                    except Exception:
                        if once:
                            raise
                        # daemon mode: a checkpoint can be listed mid-save;
                        # leave it un-evaluated and retry on the next poll
                        logger.exception(
                            f"eval daemon: checkpoint {ck} failed "
                            "(possibly mid-save); will retry"
                        )
                        break
                    evaluated.add(ck)
                    index += 1
                    last_new = time.time()
                if once:
                    break
                idle = time.time() - last_new
                if idle_timeout > 0 and idle > idle_timeout:
                    logger.info(
                        f"eval daemon: no new checkpoint in {idle:.0f}s "
                        f"(POLL_IDLE_TIMEOUT_SEC={idle_timeout:.0f}); exiting "
                        f"after {len(evaluated)} checkpoints"
                    )
                    break
                time.sleep(interval)



# (metrics key, tag) of each scalar logged per train step, under the JAX
# flat trainer's tags
FLAT_TRAIN_SCALARS = (("action_loss", "Action Loss"), ("stop_loss", "Stop Loss"),
                      ("aux_loss", "Aux Loss"), ("total_loss", "Total Loss"))
FLAT_VAL_SCALARS = (("action_loss", "Val Action Loss"), ("stop_loss", "Val Stop Loss"),
                    ("total_loss", "Val Total Loss"))


@register_trainer("robo_vln_trainer")
class RoboVLNTrainer(BaseTrainer):
    """The flat family's trainer.  Weights are random from
    ``TASK_CONFIG.SEED``, then the pretrained backbones and the GloVe table
    are read where their files exist (utils/pretrained.py)."""

    POLICIES = ("policy",)

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
        self.policy = None
        self.state = None
        self._train_steps = 0
        self._val_steps = 0
        self.pretrained_backbones = {}

    def _setup_policy(self, load_from_ckpt: bool = False, ckpt_path: str = "") -> None:
        cfg = self.config
        cm_attention.set_float32_probabilities(cfg.TPU.PALLAS_ATTENTION)
        sim = cfg.TASK_CONFIG.SIMULATOR
        self.policy = build_flat_policy(
            cfg.MODEL, compute_dtype=self.dtype,
            generator=torch.Generator().manual_seed(cfg.TASK_CONFIG.SEED),
            rgb_hw=(sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH),
        )
        self.pretrained_backbones = graft_pretrained(self.policy, cfg.MODEL)
        self.policy.to(self.device)
        n_params = sum(p.numel() for p in self.policy.parameters())
        logger.info(f"agent number of parameters: {n_params}")
        self.state = steps_lib.TrainState(
            opt_lib.adam(self.policy, 0.0, self._unfrozen_names()), 0)
        if load_from_ckpt and ckpt_path:
            self.state = ckpt_lib.load_flat_checkpoint(ckpt_path, self.policy, self.state)
            logger.info(f"Loaded weights from checkpoint: {ckpt_path}")
        pm = cfg.MODEL.PROGRESS_MONITOR
        vvm = cfg.TPU.VALID_MASK_VELOCITY_MSE
        self.train_step = steps_lib.make_flat_train_step(
            self.policy, use_progress=pm.use, progress_alpha=pm.alpha,
            remat=cfg.TPU.REMAT, valid_velocity_mse=vvm, mesh=self.mesh)
        self.val_step = steps_lib.make_flat_val_step(
            self.policy, use_progress=pm.use, progress_alpha=pm.alpha,
            valid_velocity_mse=vvm, mesh=self.mesh)

    def _optimizers(self):
        return (self.state.optimizer,)

    def _featurized_dirs(self):
        """The feature-store twins of the train and eval buffers
        (DAGGER.PRELOAD_TRUNK_FEATURES, training/featurize.py), built or
        refreshed by the policy's frozen ResNet trunks; with another
        encoder (SimpleCNN) a warning and the raw buffers, as in JAX."""
        from .featurize import ensure_featurized

        mc = self.config.MODEL
        if (mc.RGB_ENCODER.cnn_type != "TorchVisionResNet50"
                or mc.DEPTH_ENCODER.cnn_type != "VlnResnetDepthEncoder"):
            logger.warning("PRELOAD_TRUNK_FEATURES requires the ResNet encoder types; "
                           "training from raw frames")
            return self.features_dir, self.eval_dir
        train_dir = ensure_featurized(self.config, self.policy, self.features_dir)
        eval_dir = self.eval_dir
        if os.path.exists(eval_dir):
            eval_dir = ensure_featurized(self.config, self.policy, eval_dir)
        return train_dir, eval_dir

    def _metadata(self):
        return {"config": self.config.to_dict(), "train_steps": int(self._train_steps),
                "val_steps": int(self._val_steps)}

    def save_checkpoint(self, file_name: str) -> None:
        path = os.path.join(self.config.CHECKPOINT_FOLDER, file_name)
        ckpt_lib.save_flat_checkpoint(path, self.policy, self.state, metadata=self._metadata())

    def train_epoch(self, batches, epoch, writer, train_steps):
        cfg = self.config
        send, receive = device_transfer(self.device)
        hidden = None
        for is_first, window in window_stream(
            batches, send,
            lambda b: split_tbptt(b, cfg.DAGGER.tbptt_steps), receive,
        ):
            if is_first:
                hidden = self.policy.initial_hidden(self.batch_size, self.device)
            self.state, hidden, metrics = self.train_step(self.state, hidden, window,
                                                          cfg.DAGGER.LR)
            values = host_values(metrics, [k for k, _ in FLAT_TRAIN_SCALARS])
            for (_, tag), value in zip(FLAT_TRAIN_SCALARS, values):
                writer.add_scalar(tag, value, train_steps)
            train_steps += 1
        self._train_steps = train_steps
        self.save_checkpoint(self._epoch_checkpoint(epoch))
        return train_steps

    def val_epoch(self, batches, epoch, writer, val_steps):
        cfg = self.config
        send, receive = device_transfer(self.device)
        totals = []
        for batch in batches:
            hidden = self.policy.initial_hidden(self.batch_size, self.device)
            for window in split_tbptt(batch, cfg.DAGGER.tbptt_steps):
                window = send(window)
                if receive is not None:
                    window = receive(window)
                hidden, metrics = self.val_step(hidden, window)
                values = host_values(metrics, [k for k, _ in FLAT_VAL_SCALARS])
                for (_, tag), value in zip(FLAT_VAL_SCALARS, values):
                    writer.add_scalar(tag, value, val_steps)
                val_steps += 1
                totals.append(values[-1])
        if totals:
            writer.add_scalar("Val Loss Epoch", float(np.mean(totals)), val_steps)
        self._val_steps = val_steps
        return val_steps

    def _eval_checkpoint(self, checkpoint_path, writer, checkpoint_index=0):
        from ..eval.evaluator import eval_flat_checkpoint

        eval_flat_checkpoint(self, checkpoint_path, writer, checkpoint_index)
