"""Carry the JAX package's HCM weights into the port's modules.

Input: the flax variables ``{"params", "batch_stats"}`` of each policy as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``).
Output: a torch state_dict under the reference's key names, which the port's
modules use, loaded with :func:`load_hierarchical_weights`.  The conversions
are the inverse of robo_vln_tpu/training/checkpoint.py's converter:

* Dense kernel (in, out) -> Linear weight (out, in); a Conv1d(k=1) gets a
  trailing axis;
* Conv kernel HWIO -> OIHW;
* LSTM w_ih (D, 4H) -> weight_ih_l0 (4H, D), likewise w_hh; b_ih and b_hh
  stay separate;
* LayerNorm / GroupNorm / BatchNorm scale -> weight; BatchNorm mean / var ->
  running_mean / running_var;
* the token-major (S, 64) spatial-embedding table -> the reference's (S, 64)
  weight whose row-major ``.view(1, -1, h, w)`` gives the table back.

The port imports nothing of the JAX package; this module only reads arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _dense(p: Mapping, prefix: str) -> StateDict:
    out = {prefix + "weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out[prefix + "bias"] = np.asarray(p["bias"])
    return out


def _conv1d(p: Mapping, prefix: str) -> StateDict:
    out = _dense(p, prefix)
    out[prefix + "weight"] = out[prefix + "weight"][:, :, None]
    return out


def _conv(p: Mapping, key: str) -> StateDict:
    return {key: np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))}


def _norm(p: Mapping, prefix: str, stats: Mapping = None) -> StateDict:
    out = {prefix + "weight": np.asarray(p["scale"]), prefix + "bias": np.asarray(p["bias"])}
    if stats is not None:
        out[prefix + "running_mean"] = np.asarray(stats["mean"])
        out[prefix + "running_var"] = np.asarray(stats["var"])
    return out


def _spatial_embeddings(table) -> np.ndarray:
    t = np.asarray(table)  # (S, D) token-major
    return np.ascontiguousarray(t.T).reshape(t.shape)


def _layer_blocks(tree: Mapping):
    """(stage, block, subtree) for every ``layer{li}_{bi}`` entry."""
    for name, sub in tree.items():
        if name.startswith("layer"):
            li, bi = name[len("layer"):].split("_")
            yield int(li), int(bi), sub


def gn_resnet_encoder_state(p: Mapping, prefix: str = "") -> StateDict:
    """GNResNetEncoder params -> habitat ResNetEncoder keys."""
    bb = p["backbone"]
    sd = _conv(bb["conv1"], prefix + "backbone.conv1.0.weight")
    sd.update(_norm(bb["gn1"], prefix + "backbone.conv1.1."))
    for li, bi, blk in _layer_blocks(bb):
        pre = f"{prefix}backbone.layer{li}.{bi}."
        for ci, (c, g) in enumerate((("conv1", "gn1"), ("conv2", "gn2"), ("conv3", "gn3"))):
            sd.update(_conv(blk[c]["conv"], f"{pre}convs.{3 * ci}.weight"))
            sd.update(_norm(blk[g], f"{pre}convs.{3 * ci + 1}."))
        if "downsample_conv" in blk:
            sd.update(_conv(blk["downsample_conv"]["conv"], pre + "downsample.0.weight"))
            sd.update(_norm(blk["downsample_gn"], pre + "downsample.1."))
    sd.update(_conv(p["compression_conv"], prefix + "compression.0.weight"))
    sd.update(_norm(p["compression_gn"], prefix + "compression.1."))
    return sd


def tv_resnet50_state(p: Mapping, stats: Mapping, prefix: str = "") -> StateDict:
    """TVResNet50 (params, batch_stats) -> torchvision keys."""
    sd = _conv(p["conv1"], prefix + "conv1.weight")
    sd.update(_norm(p["bn1"], prefix + "bn1.", stats["bn1"]))
    for li, bi, blk in _layer_blocks(p):
        pre = f"{prefix}layer{li}.{bi}."
        st = stats[f"layer{li}_{bi}"]
        for ci in (1, 2, 3):
            sd.update(_conv(blk[f"conv{ci}"]["conv"], f"{pre}conv{ci}.weight"))
            sd.update(_norm(blk[f"bn{ci}"], f"{pre}bn{ci}.", st[f"bn{ci}"]))
        if "downsample_conv" in blk:
            sd.update(_conv(blk["downsample_conv"]["conv"], pre + "downsample.0.weight"))
            sd.update(_norm(blk["downsample_bn"], pre + "downsample.1.", st["downsample_bn"]))
    return sd


def bert_state(p: Mapping, prefix: str = "") -> StateDict:
    """BertEncoder params -> HuggingFace BertModel keys."""
    e = prefix + "embeddings."
    sd = {
        e + "word_embeddings.weight": np.asarray(p["word_embeddings"]),
        e + "position_embeddings.weight": np.asarray(p["position_embeddings"]),
        e + "token_type_embeddings.weight": np.asarray(p["token_type_embeddings"]),
    }
    sd.update(_norm(p["embeddings_ln"], e + "LayerNorm."))
    i = 0
    while f"layer_{i}" in p:
        lp, t = p[f"layer_{i}"], f"{prefix}encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd.update(_dense(lp[name], f"{t}attention.self.{name}."))
        sd.update(_dense(lp["attention_output"], t + "attention.output.dense."))
        sd.update(_norm(lp["attention_ln"], t + "attention.output.LayerNorm."))
        sd.update(_dense(lp["intermediate"], t + "intermediate.dense."))
        sd.update(_dense(lp["output"], t + "output.dense."))
        sd.update(_norm(lp["output_ln"], t + "output.LayerNorm."))
        i += 1
    return sd


def visual_ling_attn_state(p: Mapping, prefix: str = "") -> StateDict:
    sd = {**_dense(p["vis_fc"], prefix + "vis_fc."),
          **_dense(p["ins_fc"], prefix + "ins_fc."),
          **_norm(p["layer_norm"], prefix + "layer_norm.")}
    i = 0
    while f"layers_{i}" in p:
        lp, t = p[f"layers_{i}"], f"{prefix}layers.{i}."
        att = lp["enc_att"]
        for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
            sd.update(_dense(att[name], f"{t}enc_att.attention.{name}."))
        sd.update(_norm(att["layer_norm"], t + "enc_att.layer_norm."))
        for name in ("fc1", "fc2"):
            sd.update(_dense(lp["pwff"][name], f"{t}pwff.{name}."))
        sd.update(_norm(lp["pwff"]["layer_norm"], t + "pwff.layer_norm."))
        i += 1
    return sd


def lstm_state(p: Mapping, prefix: str) -> StateDict:
    return {
        prefix + "weight_ih_l0": np.asarray(p["w_ih"]).T,
        prefix + "weight_hh_l0": np.asarray(p["w_hh"]).T,
        prefix + "bias_ih_l0": np.asarray(p["b_ih"]),
        prefix + "bias_hh_l0": np.asarray(p["b_hh"]),
    }


def _heads(params: Mapping, names) -> StateDict:
    sd = {}
    for name in names:
        if name in params:
            sd.update(_dense(params[name], name + "."))
    return sd


def high_level_state_dict(variables: Mapping) -> StateDict:
    """HighLevelPolicy variables -> the port's HighLevelPolicy state_dict."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    de, re = p["depth_encoder"], p["rgb_encoder"]
    sd = bert_state(p["embedding_layer"], "embedding_layer.")
    sd.update(gn_resnet_encoder_state(de["visual_encoder"], "depth_encoder.visual_encoder."))
    sd["depth_encoder.spatial_embeddings.weight"] = _spatial_embeddings(de["spatial_embeddings"])
    sd.update(tv_resnet50_state(re["cnn"], stats["rgb_encoder"]["cnn"], "rgb_encoder.cnn."))
    sd["rgb_encoder.spatial_embeddings.weight"] = _spatial_embeddings(re["spatial_embeddings"])
    sd.update(_conv1d(p["rgb_kv"], "rgb_kv."))
    sd.update(_conv1d(p["depth_kv"], "depth_kv."))
    sd.update(visual_ling_attn_state(p["image_cm_encoder"], "image_cm_encoder."))
    sd.update(_dense(p["rgb_linear"], "rgb_linear.2."))
    sd.update(_dense(p["depth_linear"], "depth_linear.1."))
    sd.update(lstm_state(p["state_encoder"], "state_encoder.rnn."))
    sd.update(_heads(p, ("progress_monitor", "linear")))
    return sd


def low_level_state_dict(variables: Mapping) -> StateDict:
    """LowLevelPolicy variables -> the port's LowLevelPolicy state_dict."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    de, re = p["depth_encoder"], p["rgb_encoder"]
    sd = gn_resnet_encoder_state(de["visual_encoder"], "depth_encoder.visual_encoder.")
    sd.update(_dense(de["visual_fc"], "depth_encoder.visual_fc.1."))
    sd.update(tv_resnet50_state(re["cnn"], stats["rgb_encoder"]["cnn"], "rgb_encoder.cnn."))
    sd.update(_dense(re["fc"], "rgb_encoder.fc."))
    sd["sub_task_embedding.weight"] = np.asarray(p["sub_task_embedding"]["embedding"])
    sd.update(lstm_state(p["state_encoder"], "state_encoder.rnn."))
    sd.update(_heads(p, ("progress_monitor", "linear", "stop_linear")))
    return sd


# keys the reference modules carry that the flax policies never create
# (their progress monitors are defined but never called)
_OPTIONAL = ("progress_monitor.",)


def load_state(module: torch.nn.Module, sd: StateDict) -> None:
    """Load ``sd`` into ``module``; every key of ``sd`` must be used, and only
    the optional keys may be left at the module's own values."""
    device = next(module.parameters()).device
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
               for k, v in sd.items()}
    result = module.load_state_dict(tensors, strict=False)
    missing = [k for k in result.missing_keys if not k.startswith(_OPTIONAL)]
    if missing or result.unexpected_keys:
        raise KeyError(f"weight port: missing {missing}, "
                       f"unexpected {result.unexpected_keys}")


def load_hierarchical_weights(high, low, high_vars: Mapping, low_vars: Mapping) -> None:
    """Load the JAX HCM variables of both policies into the port's modules."""
    load_state(high, high_level_state_dict(high_vars))
    load_state(low, low_level_state_dict(low_vars))
