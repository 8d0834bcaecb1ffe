"""The trainers' shared loop logic (counterpart of ``BaseTrainer`` and the
batch pipeline of robo_vln_tpu/training/trainer.py).

Epoch bookkeeping is plain Python and follows the JAX package line for
line: where a resumed run starts (:meth:`BaseTrainer._find_resume`), which
epochs each DAgger iteration trains (:meth:`BaseTrainer._iteration_plan`,
global epoch numbers, so checkpoint names ``ckpt.{EPOCHS+epoch}`` stay
monotonic), and the batches of one epoch (:meth:`BaseTrainer._batches`,
seeded by the epoch, so a resumed run reads what an uninterrupted one
reads), the eval's checkpoint sweep and daemon (:meth:`BaseTrainer.eval`,
each checkpoint through the subclass's ``_eval_checkpoint``), and DAgger
collection into the buffer (:meth:`BaseTrainer._update_dataset`, envs/).
Of the flat family's ``RoboVLNTrainer`` the port has the collect-only run of
the collection configs (robovln_data_{train,val}.yaml); its training and
eval wait for ROADMAP §A item 6.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterator

from ..data.loader import TrajectoryDataset, batch_iterator
from ..data.trajectory_store import TrajectoryStore
from ..utils.device import resolve_device
from ..utils.logging import MetricsWriter, logger
from ..utils.registry import register_trainer
from . import checkpoint as ckpt_lib


class BaseTrainer:
    """Subclasses set ``config`` and ``batch_size``."""

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
        """The static-shape batches of one epoch, in the order ``seed``
        gives (the in-process loader; DAGGER.LOADER_WORKERS > 1 is refused
        by the trainer before any work)."""
        cfg = self.config
        dataset = TrajectoryDataset(
            features_dir,
            batch_size=self.batch_size,
            is_bert=cfg.MODEL.INSTRUCTION_ENCODER.is_bert,
            use_iw=cfg.DAGGER.USE_IW,
            inflection_weight_coef=cfg.MODEL.inflection_weight_coef,
            seed=seed,
        )
        return batch_iterator(
            dataset,
            self.batch_size,
            list(cfg.DAGGER.EPISODE_LEN_BUCKETS),
            cfg.DAGGER.MAX_INSTRUCTION_LEN,
        )

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


_FLAT_FAMILY = ("the flat family's models, RoboVLNTrainer's training and eval and its "
                "DAgger mixer are not ported yet (ROADMAP §A item 6)")


@register_trainer("robo_vln_trainer")
class RoboVLNTrainer(BaseTrainer):
    """The flat family's trainer, of which the port has the collect-only run
    (DAGGER.COLLECT_ONLY with PRELOAD_LMDB_FEATURES false, the collection
    configs robovln_data_{train,val}.yaml): expert rollouts into
    DAGGER.LMDB_FEATURES_DIR before any policy is built
    (robo_vln_tpu/training/trainer.py:436-446).  Anything else it would do
    raises before any work (ROADMAP §A item 6)."""

    def __init__(self, config):
        self.config = config
        self.device = resolve_device(config.DEVICE)
        self.features_dir = config.DAGGER.LMDB_FEATURES_DIR.format(
            split=config.TASK_CONFIG.DATASET.SPLIT
        )

    def train(self) -> None:
        d = self.config.DAGGER
        if d.PRELOAD_LMDB_FEATURES or not d.COLLECT_ONLY:
            raise NotImplementedError(
                "robo_vln_trainer without DAGGER.COLLECT_ONLY (or with "
                f"DAGGER.PRELOAD_LMDB_FEATURES): {_FLAT_FAMILY}; the port runs the "
                "collect-only configs, and trains the hierarchical_trainer")
        if self._collection_beta(0) < 1.0:
            raise NotImplementedError(
                f"robo_vln_trainer collection with beta = {self._collection_beta(0)} < 1 "
                f"(DAGGER.P < 1 with LOAD_FROM_CKPT): {_FLAT_FAMILY}")
        self._update_dataset(0)
        logger.info("Data collection complete")

    def eval(self) -> None:
        raise NotImplementedError(f"robo_vln_trainer eval: {_FLAT_FAMILY}")
