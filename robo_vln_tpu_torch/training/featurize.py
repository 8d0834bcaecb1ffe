"""Trunk-feature store: run the frozen trunks and BERT over a collected
buffer once, then train from their outputs (counterpart of
robo_vln_tpu/training/featurize.py, ``DAGGER.PRELOAD_TRUNK_FEATURES``).

The frozen conv trunks (the GN-ResNet50 depth trunk, the torchvision
ResNet50) and frozen BERT never change during IL training, so their outputs
are a pure function of the buffer.  :func:`ensure_featurized` keeps a
sibling store ``<buffer>.features`` whose episodes carry ``rgb_features``
(T, 7, 7, 2048) and ``depth_features`` (T, 8, 8, C) in float16, laid out as
``models.make_shared_trunk_fn`` returns them, in place of the raw frames.
The HCM high level's buffers (a policy with a top-level BERT,
``embedding_layer``) also carry one ``instruction_embedding`` (L, 768)
float16 row: BERT over the episode's ids zero-padded to
``DAGGER.MAX_INSTRUCTION_LEN`` with no attention mask, exactly what the
collated train batch feeds it (so the pad length is part of the function).
The flat family's (CMA, the ResNet Seq2Seq) carry the trunks' features
alone: their instruction encoders train, or sit inside the instruction
encoder, as in the JAX package.  The encoders take the features through
their ``*_features`` path and the high level takes the row through its
``instruction_embedding`` path, so the train step runs only the trainable
stack.

The cache is keyed by :func:`trunk_fingerprint`, the port's own hash of the
frozen tensors: a cache that the JAX package wrote (its hash is over its
own parameter trees) is stale here and is rebuilt, never reused.  Closed-loop
eval always runs the full forward (its frames come from the simulator).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

from ..data import serialization
from ..data.trajectory_store import TrajectoryStore
from ..models import make_shared_trunk_fn
from ..utils.device import float32_exact
from ..utils.logging import logger

META = "featurize_meta.json"
CHUNK = 32  # frames a trunk call, the last chunk of an episode zero-padded
_FROZEN = ("rgb_encoder.cnn.", "depth_encoder.visual_encoder.", "embedding_layer.")


def _has_bert(policy) -> bool:
    return hasattr(policy, "embedding_layer")


def trunk_fingerprint(policy) -> str:
    """sha256 over the policy's frozen trunks and its top-level BERT: every
    tensor (parameters and BatchNorm buffers) of its ``state_dict`` under
    those modules, in sorted key order, each key's name, dtype, shape and
    bytes."""
    h = hashlib.sha256()
    state = policy.state_dict()
    for key in sorted(k for k in state if k.startswith(_FROZEN)):
        t = state[key].detach().cpu().contiguous()
        h.update(f"{key}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@torch.no_grad()
def featurize_buffer(policy, raw_dir: str, out_dir: str, start_key: int = 0,
                     max_instruction_len: int = 200) -> Dict[str, int]:
    """Write the featurized twin of the episodes ``start_key``.. of
    ``raw_dir`` into ``out_dir``, in the flat wire format, with the
    policy's trunks (and the high level's BERT) on its device and in its
    compute dtype.  Every key of an episode but rgb and depth is kept.
    Returns the counts of episodes, frames, and feature values outside
    float16's range (they store as inf; 0 for bfloat16 or float32 trunks on
    real frames)."""
    device = next(policy.parameters()).device
    trunk_fn = make_shared_trunk_fn(policy)
    overflow = torch.zeros((), dtype=torch.int64, device=device)

    def to_f16(x):
        nonlocal overflow
        half = x.to(torch.float16)
        overflow += (torch.isinf(half) & torch.isfinite(x)).sum()
        return half

    n_eps = n_frames = 0
    with TrajectoryStore(raw_dir) as src, TrajectoryStore(out_dir, writable=True) as dst, \
            float32_exact(policy.compute_dtype):
        total = len(src)
        for key in range(start_key, total):
            obs, prev, corr, stop = serialization.unpackb_any(src.get_buffer(key))
            rgb, depth = np.asarray(obs["rgb"]), np.asarray(obs["depth"])
            t = rgb.shape[0]
            rgb_f, depth_f = [], []
            for s in range(0, t, CHUNK):
                r = np.zeros((CHUNK,) + rgb.shape[1:], rgb.dtype)
                d = np.zeros((CHUNK,) + depth.shape[1:], depth.dtype)
                n = min(CHUNK, t - s)
                r[:n], d[:n] = rgb[s:s + n], depth[s:s + n]
                feats = trunk_fn({"rgb": torch.from_numpy(r).to(device),
                                  "depth": torch.from_numpy(d).to(device)})
                rgb_f.append(to_f16(feats["rgb_features"][:n]))
                depth_f.append(to_f16(feats["depth_features"][:n]))
            new_obs = {k: v for k, v in obs.items() if k not in ("rgb", "depth")}
            new_obs["rgb_features"] = torch.cat(rgb_f).cpu().numpy()
            new_obs["depth_features"] = torch.cat(depth_f).cpu().numpy()
            if _has_bert(policy):
                # the ids as the collated train batch feeds BERT: the
                # episode's row zero-padded to MAX_INSTRUCTION_LEN, no
                # attention mask
                row = np.asarray(obs["instruction"]).reshape(t, -1)[0]
                ids = np.zeros(max_instruction_len, np.int32)
                n_ids = min(len(row), max_instruction_len)
                ids[:n_ids] = row[:n_ids]
                emb = policy.embed_instruction(torch.from_numpy(ids)[None].to(device))
                new_obs["instruction_embedding"] = to_f16(emb[0]).cpu().numpy()
            dst.put(key, serialization.pack_flat([new_obs, prev, corr, stop]))
            n_eps += 1
            n_frames += t
            if n_eps % 100 == 0:
                dst.flush()
                logger.info(f"featurized {n_eps}/{total - start_key} episodes")
        dst.flush()
    stats = {"episodes": n_eps, "frames": n_frames, "out_of_f16_range": int(overflow)}
    if stats["out_of_f16_range"]:
        logger.warning(f"featurize: {stats['out_of_f16_range']} feature values lie outside "
                       "float16's range and are stored as inf")
    return stats


def ensure_featurized(config, policy, raw_dir: str) -> str:
    """The featurized twin ``<raw_dir>.features`` of ``raw_dir`` by
    ``policy`` (the HCM high level, or a flat policy with the ResNet
    encoders): reused when its fingerprint and episode count match, and for
    the high level, whose rows bake the pad length in, its
    ``max_instruction_len``; appended with only the new episodes when the
    buffer has grown under the same fingerprint (and length); rebuilt
    otherwise."""
    out_dir = raw_dir.rstrip("/") + ".features"
    fp = trunk_fingerprint(policy)
    max_len = config.DAGGER.MAX_INSTRUCTION_LEN
    with TrajectoryStore(raw_dir) as src:
        src_len = len(src)
    meta_path = os.path.join(out_dir, META)
    start_key = 0
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        have = meta.get("episodes", 0)
        same = meta.get("fingerprint") == fp and (
            not _has_bert(policy) or meta.get("max_instruction_len") == max_len)
        if same and have == src_len:
            logger.info(f"reusing featurized buffer {out_dir} ({src_len} episodes)")
            return out_dir
        if same and 0 < have < src_len:
            # keys are dense and append-only: a DAgger loop featurizes only
            # the episodes its last collection added
            start_key = have
            logger.info(f"featurized buffer {out_dir}: appending episodes "
                        f"{start_key}..{src_len - 1}")
        else:
            logger.info(f"featurized buffer {out_dir} is stale (frozen weights or "
                        "MAX_INSTRUCTION_LEN changed, or the source shrank); rebuilding")
            shutil.rmtree(out_dir, ignore_errors=True)
    elif os.path.exists(out_dir):
        shutil.rmtree(out_dir)  # no metadata: a build that did not finish
    stats = featurize_buffer(policy, raw_dir, out_dir, start_key=start_key,
                             max_instruction_len=max_len)
    with open(meta_path, "w") as f:
        json.dump({"fingerprint": fp, "episodes": start_key + stats["episodes"],
                   "source": raw_dir, "max_instruction_len": max_len}, f)
    logger.info(f"featurized {stats['episodes']} episodes ({stats['frames']} frames; "
                f"{start_key + stats['episodes']} in all) -> {out_dir}")
    return out_dir
