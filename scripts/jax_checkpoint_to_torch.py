#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (robo_vln_tpu) into one of the
PyTorch port (robo_vln_tpu_torch), so that training resumes, or the eval
runs, on the port where the JAX run left off.

    python scripts/jax_checkpoint_to_torch.py --jax data/checkpoints/ckpt.12 \
        --out data/checkpoints_torch/ckpt.12 \
        [--exp-config robo_vln_tpu_torch/config/configs/hierarchical_cma.yaml] \
        [OPT.KEY value ...]

It reads the JAX checkpoint directory, which needs JAX and orbax (run it on a
machine that has them; the port's own machine need not): the orbax train
state, ``extra_variables.npz`` (the frozen BatchNorm statistics that
``save_extra_variables`` writes beside it) and ``framework_metadata.json``.
Both families convert: the hierarchical trainer's two policies and the flat
trainer's CMA or Seq2Seq, told apart by the state's layout.  It writes a port
checkpoint directory (``train_state.pt`` + ``framework_metadata.json``,
robo_vln_tpu_torch/training/checkpoint.py):

* the weights, through the port's utils/weight_port (the reference's key
  names);
* the optimizers' state: optax ``scale_by_adam``'s ``mu``, ``nu`` and
  ``count`` become torch Adam/AdamW's ``exp_avg``, ``exp_avg_sq`` and
  ``step`` for every trainable parameter of the port's optimizers (built as
  the port's trainers build them: AdamW over the high level, Adam over the
  low level or the flat policy); a parameter trainable in the port with no
  moment in the checkpoint raises;
* the step counters, and the metadata's loop counters (``scheduler_step``,
  the cyclic LR's position; ``train_steps``, ``val_steps``), so that a
  resume (DAGGER.RESUME) continues the JAX run;
* the config: the port's defaults (or ``--exp-config``), each key the port's
  tree has set from the checkpoint's config, then the trailing options.

The output's directory name keeps the JAX scheme (``ckpt.{N}``), which a
resume reads its epoch from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

COUNTERS = ("scheduler_step", "train_steps", "val_steps")


def read_jax_checkpoint(path: str):
    """(train state as nested dicts, extra variables, metadata) of a JAX
    checkpoint directory.  The state is restored without a target, so a
    NamedTuple comes back as a dict of its fields and optax's MaskedNode
    (a frozen leaf's moment) as None."""
    import orbax.checkpoint as ocp

    from robo_vln_tpu.training import checkpoint as jax_ckpt

    state = ocp.StandardCheckpointer().restore(os.path.abspath(path))
    extra = jax_ckpt.load_extra_variables(path) or {}
    meta = jax_ckpt.load_metadata(path) or {}
    return state, extra, meta


def adam_moments(opt_state):
    """The one ``scale_by_adam`` state ({count, mu, nu}) inside an optax
    state."""
    found = []

    def walk(node):
        if isinstance(node, dict):
            if {"count", "mu", "nu"} <= set(node):
                found.append(node)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state in the optimizer state, found {len(found)}")
    return found[0]


def _fill(tree, like):
    """``tree`` with each None leaf (no moment: a frozen parameter) replaced
    by NaNs shaped like ``like``'s leaf."""
    if isinstance(like, dict):
        tree = tree or {}
        return {k: _fill(tree.get(k), v) for k, v in like.items()}
    if tree is None:
        return np.full(np.shape(like), np.nan, np.float32)
    return np.asarray(tree)


def _merge_known(cfg, values) -> None:
    """Set each key of ``values`` that ``cfg`` has (recursively)."""
    from robo_vln_tpu_torch.config.tree import ConfigTree

    for k, v in values.items():
        if k not in cfg:
            continue
        if isinstance(cfg[k], ConfigTree):
            if isinstance(v, dict):
                _merge_known(cfg[k], v)
        else:
            cfg[k] = v


def port_config(ckpt_config, exp_config=None, opts=()):
    from robo_vln_tpu_torch.config import get_config

    cfg = get_config(exp_config).clone().defrost()
    _merge_known(cfg, ckpt_config or {})
    # port-only: the depth frame's side, which get_config takes from the sensor
    cfg.MODEL.DEPTH_ENCODER.input_size = cfg.TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.DEVICE = "cpu"  # a checkpoint holds host tensors; the loader moves them
    cfg.freeze()
    return cfg


def set_adam_state(module, optimizer, level_state, variables, to_state_dict) -> None:
    """Give each parameter of ``optimizer`` its Adam moments and step from
    the JAX level's state."""
    import torch

    moments = adam_moments(level_state["opt_state"])
    count = float(np.asarray(moments["count"]))
    extras = {k: v for k, v in variables.items() if k != "params"}
    mu = to_state_dict({**extras, "params": _fill(moments["mu"], variables["params"])})
    nu = to_state_dict({**extras, "params": _fill(moments["nu"], variables["params"])})
    names = {id(p): n for n, p in module.named_parameters()}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            if name not in mu:  # a parameter the flax policy never creates
                continue
            m, v = (np.asarray(t, np.float32).reshape(p.shape) for t in (mu[name], nu[name]))
            if np.isnan(m).any() or np.isnan(v).any():
                raise ValueError(f"{name} is trainable in the port but has no Adam moment "
                                 "in the checkpoint (frozen there)")
            optimizer.state[p] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.from_numpy(m.copy()).to(p.device),
                "exp_avg_sq": torch.from_numpy(v.copy()).to(p.device),
            }


def convert(jax_dir: str, out_dir: str, exp_config=None, opts=()) -> dict:
    """Write the port checkpoint of ``jax_dir`` at ``out_dir``; returns its
    metadata."""
    from robo_vln_tpu_torch.models import build_flat_policy, build_hierarchical_policies
    from robo_vln_tpu_torch.training import checkpoint as ckpt_lib
    from robo_vln_tpu_torch.training import optimizers as opt_lib
    from robo_vln_tpu_torch.training.steps import HierTrainState, TrainState
    from robo_vln_tpu_torch.utils import weight_port as wp

    state, extra, meta = read_jax_checkpoint(jax_dir)
    cfg = port_config(meta.get("config"), exp_config, opts)
    unfrozen = ("embedding_layer",) if cfg.MODEL.BERT.trainable else ()
    metadata = {"config": cfg.to_dict(), **{k: int(meta[k]) for k in COUNTERS if k in meta},
                "converted_from": os.path.abspath(jax_dir)}
    if "high" in state:  # the hierarchical trainer's HierTrainState
        high, low = build_hierarchical_policies(cfg.MODEL)
        hv = {"params": state["high"]["params"], **extra.get("high", {})}
        lv = {"params": state["low"]["params"], **extra.get("low", {})}
        wp.load_hierarchical_weights(high, low, hv, lv)
        wd = cfg.MODEL.TRANSFORMER.weight_decay
        opt_high = opt_lib.adamw(high, wd, unfrozen)
        opt_low = opt_lib.adam(low, wd, unfrozen)
        set_adam_state(high, opt_high, state["high"], hv, wp.high_level_state_dict)
        set_adam_state(low, opt_low, state["low"], lv, wp.low_level_state_dict)
        train_state = HierTrainState(
            TrainState(opt_high, int(np.asarray(state["high"]["step"]))),
            TrainState(opt_low, int(np.asarray(state["low"]["step"]))))
        ckpt_lib.save_checkpoint(out_dir, high, low, train_state, metadata)
    else:  # the flat trainer's TrainState
        sim = cfg.TASK_CONFIG.SIMULATOR
        policy = build_flat_policy(cfg.MODEL, rgb_hw=(sim.RGB_SENSOR.HEIGHT, sim.RGB_SENSOR.WIDTH))
        variables = {"params": state["params"], **extra}
        wp.load_flat_weights(policy, variables)
        opt = opt_lib.adam(policy, 0.0, unfrozen)
        set_adam_state(policy, opt, state, variables, wp.flat_state_dict)
        ckpt_lib.save_flat_checkpoint(out_dir, policy,
                                      TrainState(opt, int(np.asarray(state["step"]))), metadata)
    return metadata


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--jax", required=True, help="the JAX package's checkpoint directory")
    parser.add_argument("--out", required=True, help="the port checkpoint directory to write")
    parser.add_argument("--exp-config", default=None,
                        help="a port yaml under the checkpoint's config (default: the "
                             "port's defaults)")
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    meta = convert(args.jax, args.out, args.exp_config, args.opts)
    print(json.dumps({k: v for k, v in meta.items() if k != "config"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
