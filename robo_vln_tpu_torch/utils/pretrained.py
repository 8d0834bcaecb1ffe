"""Pretrained weights for the frozen backbones (counterpart of
robo_vln_tpu/utils/pretrained.py).

The reference loads three pretrained weight sets when it builds a policy:
the DDPPO depth ResNet, torchvision's ImageNet ResNet50 and HuggingFace's
bert-base.  They arrive as local files, the original torch artifacts
(``.pth``) or ``.npz`` exports of them (:func:`export_torch_to_npz`):

  MODEL.DEPTH_ENCODER.ddppo_checkpoint  (a DDPPO .pth, ``actor_critic.net.
                                         visual_encoder.*``, or a bare encoder)
  MODEL.RGB_ENCODER.pretrained_weights  (torchvision ResNet50, BatchNorm
                                         statistics included; ``fc.*`` unread)
  MODEL.BERT.pretrained_weights         (HF BertModel, cut to
                                         MODEL.BERT.num_layers)

The port's modules keep the reference's ``state_dict`` names, so a file maps
onto each :class:`GNResNetEncoder`, :class:`TVResNet50` or
:class:`BertEncoder` of a policy by a prefix strip and a filter.
:func:`graft_pretrained` loads every such module a policy holds and returns
the JAX package's provenance record: per backbone ``loaded``,
``missing_file`` (the policy holds it, no file: it stays random, with a log
line), ``not_in_model`` or ``error`` (a key missing from the file, with a
warning; or every module skipped for a shape mismatch, each with a
warning).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..models.encoders.bert import BertEncoder
from ..models.encoders.resnet import GNResNetEncoder, TVResNet50
from .logging import logger

StateDict = Dict[str, np.ndarray]

# ResNet stage blocks in a key: a file with blocks the module lacks is a
# shape mismatch, as the JAX package infers the depth from the file
_BLOCK = re.compile(r"^(?:backbone\.)?layer\d+\.\d+\.")


def load_state_dict(path: str) -> Optional[StateDict]:
    """The file's tensors by name (a ``.pth`` holding ``{"state_dict": ...}``
    is unwrapped), or None when ``path`` is empty or absent."""
    if not path or not os.path.exists(path):
        return None
    if path.endswith(".npz"):
        return dict(np.load(path, allow_pickle=False))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    return {k: np.asarray(v) for k, v in ckpt.items()}


def ddppo_depth_state(sd: Mapping) -> StateDict:
    """A DDPPO checkpoint's ``<a>.<b>.visual_encoder.*`` keys with that
    prefix stripped (the reference's stripping); a bare encoder as it is."""
    if not any(k.startswith("actor_critic") for k in sd):
        return dict(sd)
    out = {}
    for k, v in sd.items():
        parts = k.split(".")[2:]
        if parts and parts[0] == "visual_encoder":
            out[".".join(parts[1:])] = v
    return out


def bert_state(sd: Mapping, num_layers: int) -> StateDict:
    """An HF BertModel's keys, its layers past ``num_layers`` dropped."""
    def keep(k):
        m = re.match(r"encoder\.layer\.(\d+)\.", k)
        return m is None or int(m.group(1)) < num_layers

    return {k: v for k, v in sd.items() if keep(k)}


def load_module(module: nn.Module, sd: Mapping, name: str) -> bool:
    """Copy ``sd`` into ``module`` (every tensor of its ``state_dict``, cast
    to the tensor's dtype); keys it does not hold are ignored.  Raises
    KeyError for a key the file lacks; on a shape mismatch, or ResNet blocks
    the module lacks, logs a warning, loads nothing and returns False."""
    own = module.state_dict()
    for k in own:
        if k not in sd:
            raise KeyError(k)
    blocks = {m.group(0) for m in map(_BLOCK.match, own) if m}
    extra = sorted({m.group(0) for m in map(_BLOCK.match, sd) if m} - blocks)
    bad = [k for k, t in own.items() if tuple(np.shape(sd[k])) != tuple(t.shape)]
    if bad or extra:
        logger.warning(f"pretrained subtree {name!r} shape mismatch "
                       f"({(bad or extra)[0]}); skipped")
        return False
    with torch.no_grad():
        for k, t in own.items():
            t.copy_(torch.from_numpy(np.array(sd[k])))
    return True


# (provenance name, MODEL stanza, key, the module class that holds the backbone,
# the file's state dict -> keys of that module)
BACKBONES = (
    ("ddppo_depth", "DEPTH_ENCODER", "ddppo_checkpoint", GNResNetEncoder,
     lambda sd, mc: ddppo_depth_state(sd)),
    ("imagenet_rgb", "RGB_ENCODER", "pretrained_weights", TVResNet50,
     lambda sd, mc: sd),
    ("bert", "BERT", "pretrained_weights", BertEncoder,
     lambda sd, mc: bert_state(sd, mc.BERT.num_layers)),
)


def graft_pretrained(module: nn.Module, model_config) -> Dict[str, Dict]:
    """Load the pretrained backbones into every backbone module ``module``
    holds, in place, and return the provenance record (the JAX package's
    ``graft_pretrained``'s), which the eval's stats carry."""
    provenance: Dict[str, Dict] = {}
    for name, stanza, key, kind, to_module in BACKBONES:
        held = [m for m in module.modules() if isinstance(m, kind)]
        if not held:
            provenance[name] = {"status": "not_in_model"}
            continue
        path = model_config[stanza][key]
        sd = load_state_dict(path)
        if sd is None:
            provenance[name] = {"status": "missing_file", "path": str(path)}
            logger.warning(f"pretrained {name} weights not found at {path!r}; "
                           f"{len(held)} {kind.__name__} module(s) stay RANDOM")
            continue
        try:
            sd = to_module(sd, model_config)
            n = sum(load_module(m, sd, name) for m in held)
        except KeyError as e:
            provenance[name] = {"status": "error", "path": str(path),
                                "detail": f"missing key {e}"}
            logger.warning(f"{name} checkpoint missing key {e}; skipped")
            continue
        provenance[name] = {"status": "loaded" if n else "error", "path": str(path)}
        logger.info(f"loaded {name} weights into {n} encoder(s)")
    return provenance


# a backbone's merged status: "loaded" only where every policy that needs it
# loaded it (the JAX hierarchical trainer's order)
_ORDER = {"missing_file": 3, "error": 2, "loaded": 1, "not_in_model": 0}


def merge_provenance(*records: Dict[str, Dict]) -> Dict[str, Dict]:
    """One record over several policies' (the high and low levels')."""
    return {k: max((r[k] for r in records), key=lambda d: _ORDER.get(d.get("status"), 0))
            for k in records[0]}


def export_torch_to_npz(torch_path: str, npz_path: str) -> None:
    """One-time conversion helper: torch state_dict -> flat .npz."""
    sd = load_state_dict(torch_path)
    np.savez(npz_path, **{k: np.asarray(v) for k, v in sd.items()})
