"""Pre-extract frozen-trunk features for a trajectory buffer (the
DAGGER.PRELOAD_TRUNK_FEATURES cache) without launching training
(counterpart of scripts/featurize_buffer.py).

    python -m robo_vln_tpu_torch.scripts.featurize_buffer \
        --exp-config robo_vln_tpu_torch/config/configs/hierarchical_cma.yaml \
        [--buffer data/trajectories_dirs/.../trajectories.store] \
        [OPT.KEY value ...]

Builds the policy for the config as the trainer does (the pretrained trunks
grafted from their files, utils/pretrained.py), then writes or refreshes
``<buffer>.features`` via training.featurize.ensure_featurized
(fingerprint-keyed: re-running with unchanged weights is a no-op).  Defaults
to the config's DAGGER.LMDB_FEATURES_DIR; pass --buffer for any other store
(e.g. the eval buffer).  Runs on DEVICE, the card unless the config says cpu.
"""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--exp-config", required=True)
    parser.add_argument("--buffer", default="",
                        help="trajectory store dir (default: the config's "
                             "DAGGER.LMDB_FEATURES_DIR for the train split)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    import robo_vln_tpu_torch.training.hierarchical_trainer  # noqa: F401 (registers)
    import robo_vln_tpu_torch.training.trainer  # noqa: F401 (registers)
    from robo_vln_tpu_torch.config import get_config
    from robo_vln_tpu_torch.models import frozen_trunks_identical
    from robo_vln_tpu_torch.training.featurize import ensure_featurized
    from robo_vln_tpu_torch.utils.logging import logger
    from robo_vln_tpu_torch.utils.registry import get_trainer

    config = get_config(args.exp_config, args.opts or None)
    trainer = get_trainer(config.TRAINER_NAME)(config)
    trainer._setup_policy()
    buffer_dir = args.buffer or trainer.features_dir
    if config.TRAINER_NAME == "hierarchical_trainer":
        if not frozen_trunks_identical(trainer.high, trainer.low):
            logger.error(
                "high/low trunk weights differ — features computed with the "
                "high level's trunks would not match the low level's")
            return 1
        policy = trainer.high
    else:
        policy = trainer.policy
    out = ensure_featurized(config, policy, buffer_dir)
    logger.info(f"feature buffer ready: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
