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
``EVAL.VAL_LOG_DIR/stats_ckpt_{i}_{split}.json``.
"""

import argparse
import json
import random

import numpy as np

from . import training  # noqa: F401 (registers the trainers)
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
    config = get_config(exp_config, opts)
    logger.info(f"config: {json.dumps(config.to_dict(), default=str)}")
    add_filehandler(config.LOG_FILE)

    random.seed(config.TASK_CONFIG.SEED)
    np.random.seed(config.TASK_CONFIG.SEED)

    trainer = get_trainer(config.TRAINER_NAME)(config)
    if run_type == "train":
        trainer.train()
    else:
        trainer.eval()


if __name__ == "__main__":
    main()
