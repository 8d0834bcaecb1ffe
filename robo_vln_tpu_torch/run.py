"""Experiment CLI of the port (counterpart of the repository's run.py).

    python -m robo_vln_tpu_torch.run --exp-config <exp>.yaml \\
        --run-type {train,eval} [OPT.KEY value ...]

Builds the config (defaults <- yaml <- trailing options), logs it as JSON,
seeds Python's and numpy's generators from TASK_CONFIG.SEED, and runs the
registered trainer's ``train()`` or ``eval()`` on ``DEVICE``: the CUDA
device unless the options say ``DEVICE cpu``; an absent CUDA device raises
before any work.  ``eval`` evaluates EVAL_CKPT_PATH_DIR (one checkpoint, a
folder sweep, or with EVAL.ONCE False the polling daemon) closed-loop on
TASK_CONFIG.SIMULATOR.TYPE's env and writes
``EVAL.VAL_LOG_DIR/stats_ckpt_{i}_{split}.json``; with EVAL.EVAL_NONLEARNING
(nonlearning.yaml) it evaluates EVAL.NONLEARNING.AGENT instead, on the
host, and writes ``stats_complete_<agent>_<split>.json``.

``train`` runs over the ``[data, model]`` grid of ``TPU.MESH_SHAPE``
(parallel/mesh.py): at the default ``[-1, 1]`` over every visible card,
``DAGGER.BATCH_SIZE`` a card; ``[d, m]`` splits the large kernels over
``m`` ranks a data rank.  With more than one rank, ``run_exp`` starts
``d·m`` processes (spawned, joined by NCCL on ``cuda:<rank>``, or by gloo
on the CPU where ``TPU.MESH_SHAPE`` asks for ranks explicitly) and waits
for them; a rank that fails ends the others and fails the run.  One rank
trains in this process, with no process group (or in the group that is
already up).  The eval and the nonlearning agents run in this one process,
as the JAX eval uses no mesh.
"""

import argparse
import json
import random

import numpy as np

from .config.default import get_config
from .utils.logging import add_filehandler, logger
from .utils.registry import get_trainer


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--run-type", choices=["train", "eval"], required=True,
        help="run type of the experiment (train, eval)",
    )
    parser.add_argument(
        "--exp-config", type=str, required=True,
        help="path to config yaml containing info about experiment",
    )
    parser.add_argument(
        "opts", default=None, nargs=argparse.REMAINDER,
        help="Modify config options from command line",
    )
    args = parser.parse_args(argv)
    run_exp(**vars(args))


def run_exp(exp_config, run_type: str, opts=None) -> None:
    """``exp_config``: a yaml path, or None for the defaults."""
    # imported here, not with the module: collection's spawned workers
    # re-import the parent's main module, and need no torch
    from . import training  # noqa: F401 (registers the trainers)

    config = get_config(exp_config, opts)
    logger.info(f"config: {json.dumps(config.to_dict(), default=str)}")
    add_filehandler(config.LOG_FILE)

    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)

    if run_type == "eval" and config.EVAL.EVAL_NONLEARNING:
        from .agents.nonlearning import evaluate_agent

        evaluate_agent(config)
        return

    if run_type == "train":
        _train(config, exp_config, list(opts or []))
    else:
        get_trainer(config.TRAINER_NAME)(config).eval()


def _train(config, exp_config, opts) -> None:
    import torch.distributed as dist

    from .parallel import mesh as mesh_lib
    from .utils.device import resolve_device

    device = resolve_device(config.DEVICE)
    if not dist.is_initialized():
        d, m = mesh_lib.mesh_axes(config.TPU.MESH_SHAPE, device)
        if d * m > 1:
            logger.info(f"starting {d} x {m} ranks (data x model)")
            mesh_lib.spawn(_train_rank, d * m, device.type, exp_config, opts)
            return
    get_trainer(config.TRAINER_NAME)(config).train()


def _train_rank(rank: int, device, exp_config, opts) -> None:
    """One rank's trainer, in a process of its own (parallel/mesh.spawn),
    on ``device``: ``cuda:<rank>``, or the CPU."""
    from . import training  # noqa: F401 (registers the trainers)

    config = get_config(exp_config, [*opts, "DEVICE", str(device)])
    if rank == 0:
        add_filehandler(config.LOG_FILE)
    else:  # rank 0 logs the run; the others only what goes wrong
        logger.setLevel("WARNING")
    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)
    get_trainer(config.TRAINER_NAME)(config).train()


if __name__ == "__main__":
    main()
