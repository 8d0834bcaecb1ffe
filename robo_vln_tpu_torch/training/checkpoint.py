"""Checkpoints of both trainers (counterpart of
robo_vln_tpu/training/checkpoint.py's save, load, list and metadata, and of
its ``load_torch_into_hier_trainer`` and ``load_torch_into_flat_trainer``).

A flat checkpoint (RoboVLNTrainer) is a directory ``ckpt.{N}/`` holding
``train_state.pt``: the policy's ``state_dict`` under the reference's key
names (so the reference's flat ``.pth``, ``{state_dict, config}``, is a
subset of it), the optimizer's ``state_dict``, its parameters' names and
the step; and ``framework_metadata.json``.

A hierarchical checkpoint is a directory ``ckpt.{N}/`` holding

* ``train_state.pt`` (``torch.save``, read back with ``weights_only=True``):
  ``high_level_state_dict`` and ``low_level_state_dict`` under the
  reference's key names, so the reference's own ``.pth`` layout
  (``{high_level_state_dict, low_level_state_dict, config}``, the
  ``HCM_Agent.pth`` layout) is a subset of it; both optimizers'
  ``state_dict``; both step counters; and the names of each optimizer's
  parameters in param-group order;
* ``framework_metadata.json``: the config, ``scheduler_step``,
  ``train_steps`` and ``val_steps``, as the JAX trainer writes them.

On a mesh only rank 0 writes (:func:`is_writer`); every rank loads.  The
policies are never wrapped (the steps all-reduce the gradients themselves,
parallel/mesh.py), so the keys carry no wrapper's prefix.  A checkpoint is
always whole: on a "model" axis every rank takes part in the save, which
gathers each split tensor and its Adam moments over the model group
(parallel/tensor.whole_state_dict, whole_optimizer_state), so the file is
the one a single process writes and any reader (the eval, the converters)
reads it unchanged; every load reads the whole file and keeps the slices
of the tensors the module splits (local_state_dict,
local_optimizer_state).

Torch keys optimizer state by the position of a parameter in its groups, so
:func:`load_checkpoint` checks the recorded names against the rebuilt
optimizers before it loads their state.  The step counters matter beyond
bookkeeping: the dropout masks of a step are drawn from a generator keyed
by the high level's step (training/steps.dropout_generator).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..parallel import tensor as tensor_lib
from .steps import HierTrainState, TrainState

TRAIN_STATE = "train_state.pt"
METADATA = "framework_metadata.json"


def _param_names(module: nn.Module, optimizer: torch.optim.Optimizer) -> List[str]:
    """The names of ``optimizer``'s parameters in param-group order."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names[id(p)] for group in optimizer.param_groups for p in group["params"]]


def _whole(module: nn.Module, optimizer: torch.optim.Optimizer):
    """(state_dict, optimizer state_dict, the optimizer's parameter names),
    each split tensor gathered whole (every rank of its model group takes
    part)."""
    names = _param_names(module, optimizer)
    return (tensor_lib.whole_state_dict(module),
            tensor_lib.whole_optimizer_state(module, optimizer.state_dict(), names), names)


def _load(module: nn.Module, optimizer: torch.optim.Optimizer, weights: Dict,
          optimizer_state: Dict, names: List[str]) -> None:
    """Whole ``weights`` and optimizer state into a module and its
    optimizer, each keeping the slices the module splits."""
    module.load_state_dict(tensor_lib.local_state_dict(module, weights))
    optimizer.load_state_dict(tensor_lib.local_optimizer_state(module, optimizer_state, names))


def save_checkpoint(path: str, high: nn.Module, low: nn.Module, state: HierTrainState,
                    metadata: Optional[Dict] = None) -> None:
    """Write ``ckpt.{N}/`` at ``path``: weights, optimizer state and step
    counters, then the metadata.  The state file is written under another
    name and renamed, so a reader never sees half of it.  Every rank calls
    it; rank 0 writes."""
    high_sd, high_opt, high_names = _whole(high, state.high.optimizer)
    low_sd, low_opt, low_names = _whole(low, state.low.optimizer)
    _write_state(path, {
        "high_level_state_dict": high_sd,
        "low_level_state_dict": low_sd,
        "high_optimizer": high_opt,
        "low_optimizer": low_opt,
        "high_step": int(state.high.step),
        "low_step": int(state.low.step),
        "high_param_names": high_names,
        "low_param_names": low_names,
    }, metadata)


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a process group,
    or a process outside any."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def write_metadata(ckpt_dir: str, metadata: Dict) -> None:
    if not is_writer():
        return
    with open(os.path.join(ckpt_dir, METADATA), "w") as f:
        json.dump(metadata, f, indent=2, default=str)


def _write_state(path: str, payload: Dict, metadata: Optional[Dict]) -> None:
    if not is_writer():
        return
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, TRAIN_STATE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, TRAIN_STATE))
    if metadata:
        write_metadata(path, metadata)


def _read_state(path: str) -> Dict:
    # read to the host: the modules and optimizers copy each tensor to its
    # parameter's device, and Adam's step counts stay on the host, where a
    # freshly built optimizer keeps them
    return torch.load(os.path.join(path, TRAIN_STATE), map_location="cpu",
                      weights_only=True)


def _check_param_names(path: str, what: str, recorded: List[str], module: nn.Module,
                       optimizer: torch.optim.Optimizer) -> None:
    rebuilt = _param_names(module, optimizer)
    if recorded != rebuilt:
        missing = sorted(set(recorded) - set(rebuilt))
        extra = sorted(set(rebuilt) - set(recorded))
        raise ValueError(
            f"{path}: {what}'s optimizer holds other parameters than the "
            f"checkpoint's (saved only: {missing}; rebuilt only: {extra}; "
            f"{'same names, other order' if not missing and not extra else ''})")


def save_flat_checkpoint(path: str, policy: nn.Module, state: TrainState,
                         metadata: Optional[Dict] = None) -> None:
    """Write a flat ``ckpt.{N}/`` at ``path``, as :func:`save_checkpoint`."""
    weights, optimizer, names = _whole(policy, state.optimizer)
    _write_state(path, {"state_dict": weights, "optimizer": optimizer,
                        "step": int(state.step), "param_names": names}, metadata)


def load_flat_checkpoint(path: str, policy: nn.Module, state: TrainState) -> TrainState:
    """Restore a flat ``ckpt.{N}/`` into the policy and the optimizer of
    ``state`` and return the state with the saved step counter; raises as
    :func:`load_checkpoint` does."""
    saved = _read_state(path)
    if "state_dict" not in saved:
        raise ValueError(f"{path} is not a flat checkpoint (no state_dict)")
    _check_param_names(path, "the policy", saved["param_names"], policy, state.optimizer)
    _load(policy, state.optimizer, saved["state_dict"], saved["optimizer"], saved["param_names"])
    return state._replace(step=saved["step"])


def load_checkpoint(path: str, high: nn.Module, low: nn.Module,
                    state: HierTrainState) -> HierTrainState:
    """Restore ``ckpt.{N}/`` into the policies and the optimizers of
    ``state`` (built as the saving trainer built them) and return the state
    with the saved step counters.  Raises when the optimizers' parameters
    are not the recorded ones, in the recorded order."""
    saved = _read_state(path)
    if "high_level_state_dict" not in saved:
        raise ValueError(f"{path} is not a hierarchical checkpoint (no high_level_state_dict)")
    for level, module, opt in (("high", high, state.high.optimizer),
                               ("low", low, state.low.optimizer)):
        _check_param_names(path, f"the {level} level", saved[f"{level}_param_names"],
                           module, opt)
    for level, module, opt in (("high", high, state.high.optimizer),
                               ("low", low, state.low.optimizer)):
        _load(module, opt, saved[f"{level}_level_state_dict"], saved[f"{level}_optimizer"],
              saved[f"{level}_param_names"])
    return HierTrainState(state.high._replace(step=saved["high_step"]),
                          state.low._replace(step=saved["low_step"]))


def load_metadata(ckpt_dir: str) -> Optional[Dict]:
    """The metadata saved next to a train state (config snapshot and the
    loop counters DAGGER.RESUME continues from), or None."""
    p = os.path.join(str(ckpt_dir), METADATA)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def list_checkpoints(folder: str) -> List[str]:
    """ckpt.{i} directories sorted by index."""
    if not os.path.isdir(folder):
        return []
    out = []
    for name in os.listdir(folder):
        if name.startswith("ckpt."):
            try:
                idx = int(name.split(".")[1])
            except (IndexError, ValueError):
                continue
            out.append((idx, os.path.join(folder, name)))
    return [p for _, p in sorted(out)]


def _reference_only(key: str) -> bool:
    """Entries of the reference's state_dicts that the port's modules do
    not build, and that no forward reads: BatchNorm's batch counter, the
    high level's defined-but-unused ``ins_fc`` (seq2seq_highlevel_cma.py:46),
    and HuggingFace BERT's pooler and position-id buffer.  The JAX
    package's converter leaves the same entries out."""
    return (key.endswith(".num_batches_tracked") or key.startswith("ins_fc.")
            or key.startswith("embedding_layer.pooler.")
            or key == "embedding_layer.embeddings.position_ids")


def load_reference_checkpoint(trainer, path: str) -> Dict[str, int]:
    """Load a reference-layout ``.pth`` (``{high_level_state_dict,
    low_level_state_dict, config}``, the ``HCM_Agent.pth`` layout) into a
    set-up trainer's policies: every weight, the frozen trunks and BERT
    included.  Apart from the entries of :func:`_reference_only`, the load
    is a strict ``load_state_dict``, whose error names each missing and
    unexpected key.  The optimizers and counters are left as they are.
    Returns the number of tensors loaded per level.

    The file is read with ``weights_only=True``: a config saved as a
    pickled object (the reference's yacs ``CfgNode``) is refused, and
    torch's error names the class to allow with
    ``torch.serialization.add_safe_globals`` if the file is trusted."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "high_level_state_dict" not in ckpt:
        raise ValueError(f"{path} is not a hierarchical checkpoint "
                         "(no high_level_state_dict); a flat one is evaluated with "
                         "TRAINER_NAME robo_vln_trainer")
    counts = {}
    for level, module in (("high", trainer.high), ("low", trainer.low)):
        sd = {k: v for k, v in ckpt[f"{level}_level_state_dict"].items()
              if not _reference_only(k)}
        module.load_state_dict(tensor_lib.local_state_dict(module, sd), strict=True)
        counts[level] = len(sd)
    return counts


def _flat_reference_only(key: str) -> bool:
    """Entries of a reference flat state_dict that no port module builds and
    no forward reads: BatchNorm's batch counter and, in the is_bert
    Seq2Seq, HuggingFace BERT's pooler and position-id buffer."""
    bert = "instruction_encoder.embedding_layer."
    return (key.endswith(".num_batches_tracked") or key.startswith(bert + "pooler.")
            or key == bert + "embeddings.position_ids")


def load_reference_flat_checkpoint(trainer, path: str) -> int:
    """Load a reference flat ``.pth`` (Seq2SeqNet or CMANet: ``{state_dict,
    config}``, or a bare state_dict) into a set-up RoboVLNTrainer's policy:
    every weight, the frozen trunks included, with a strict
    ``load_state_dict`` apart from :func:`_flat_reference_only`'s entries.
    The optimizer and counters are left as they are.  Returns the number of
    tensors loaded.  A hierarchical checkpoint is refused, naming the
    trainer that reads it; the file is read with ``weights_only=True``, as
    :func:`load_reference_checkpoint` reads it."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "high_level_state_dict" in ckpt:
        raise ValueError(f"{path} is a hierarchical (HCM) checkpoint; evaluate it with "
                         "TRAINER_NAME hierarchical_trainer")
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else None
    if not isinstance(sd, dict):
        raise ValueError(f"{path} holds no flat policy state_dict")
    sd = {k: v for k, v in sd.items() if not _flat_reference_only(k)}
    trainer.policy.load_state_dict(tensor_lib.local_state_dict(trainer.policy, sd), strict=True)
    return len(sd)
