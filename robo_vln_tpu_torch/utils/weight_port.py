"""Carry the JAX package's weights into the port's modules: the HCM
agent's two policies and the flat family's CMA and Seq2Seq.

Input: the flax variables ``{"params", "batch_stats"}`` of each policy as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, variables)``).
Output: a torch state_dict under the reference's key names, which the port's
modules use, loaded with :func:`load_hierarchical_weights`.  The conversions
are the inverse of robo_vln_tpu/training/checkpoint.py's converter:

* Dense kernel (in, out) -> Linear weight (out, in); a Conv1d(k=1) gets a
  trailing axis;
* Conv kernel HWIO -> OIHW;
* LSTM or GRU w_ih (D, gates·H) -> weight_ih_l0 (gates·H, D), likewise
  w_hh; b_ih and b_hh stay separate; an instruction RNN's backward
  direction (``bwd``) -> the ``_reverse`` keys;
* SimpleCNN's conv1..3 and fc -> ``cnn.0``, ``cnn.2``, ``cnn.4``, ``cnn.6``,
  the fc's rows reordered from the flax flatten (h, w, C) to torch's
  channel-major (C, h, w);
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


def mha_state(p: Mapping, prefix: str = "") -> StateDict:
    """MultiHeadAttention params -> its keys (``attention.fc_q`` ...)."""
    sd = {}
    for name in ("fc_q", "fc_k", "fc_v", "fc_o"):
        sd.update(_dense(p[name], f"{prefix}attention.{name}."))
    sd.update(_norm(p["layer_norm"], prefix + "layer_norm."))
    return sd


def pwff_state(p: Mapping, prefix: str = "") -> StateDict:
    """PositionWiseFeedForward params -> its keys."""
    sd = {**_dense(p["fc1"], prefix + "fc1."), **_dense(p["fc2"], prefix + "fc2.")}
    sd.update(_norm(p["layer_norm"], prefix + "layer_norm."))
    return sd


def _stack(p: Mapping, prefix: str, layer_state) -> StateDict:
    """Every ``layers_{i}`` subtree -> ``layers.{i}.`` keys."""
    sd, i = {}, 0
    while f"layers_{i}" in p:
        sd.update(layer_state(p[f"layers_{i}"], f"{prefix}layers.{i}."))
        i += 1
    return sd


def inter_module_attn_layer_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**mha_state(p["enc_att"], prefix + "enc_att."),
            **pwff_state(p["pwff"], prefix + "pwff.")}


def visual_ling_attn_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**_dense(p["vis_fc"], prefix + "vis_fc."),
            **_dense(p["ins_fc"], prefix + "ins_fc."),
            **_norm(p["layer_norm"], prefix + "layer_norm."),
            **_stack(p, prefix, inter_module_attn_layer_state)}


# the blocks no policy builds (models/transformer.py), one function each


def encoder_layer_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**mha_state(p["mhatt"], prefix + "mhatt."), **pwff_state(p["pwff"], prefix + "pwff.")}


def base_encoder_state(p: Mapping, prefix: str = "") -> StateDict:
    return _stack(p, prefix, encoder_layer_state)


def _input_stage_state(p: Mapping, prefix: str) -> StateDict:
    """The ``fc`` (where there is one) and ``layer_norm`` of an input stage."""
    sd = _norm(p["layer_norm"], prefix + "layer_norm.")
    if "fc" in p:
        sd.update(_dense(p["fc"], prefix + "fc."))
    return sd


def transformer_language_encoder_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**_input_stage_state(p, prefix),
            **base_encoder_state(p["encoder"], prefix + "encoder.")}


def decoder_layer_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**mha_state(p["self_att"], prefix + "self_att."),
            **mha_state(p["enc_att"], prefix + "enc_att."),
            **pwff_state(p["pwff"], prefix + "pwff.")}


def inter_module_attn_decoder_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**_input_stage_state(p, prefix), **_stack(p, prefix, inter_module_attn_layer_state)}


def image_cross_modal_encoder_state(p: Mapping, prefix: str = "") -> StateDict:
    return {**_input_stage_state(p, prefix), **_stack(p, prefix, decoder_layer_state)}


def position_embedding_2d_state(p: Mapping, prefix: str = "") -> StateDict:
    return {prefix + "row_embed.weight": np.asarray(p["row_embed"]),
            prefix + "col_embed.weight": np.asarray(p["col_embed"])}


# the same layouts: a LayerNorm input stage (no fc) and DecoderLayers; an
# input stage and a BaseEncoder
image_encoder_with_pos_encodings_state = image_cross_modal_encoder_state
image_plain_encoder_state = transformer_language_encoder_state


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
    sd.update(rnn_state(p["state_encoder"], "state_encoder.rnn."))
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
    sd.update(rnn_state(p["state_encoder"], "state_encoder.rnn."))
    sd.update(_heads(p, ("progress_monitor", "linear", "stop_linear")))
    return sd


def rnn_state(p: Mapping, prefix: str, suffix: str = "") -> StateDict:
    return {
        f"{prefix}weight_ih_l0{suffix}": np.asarray(p["w_ih"]).T,
        f"{prefix}weight_hh_l0{suffix}": np.asarray(p["w_hh"]).T,
        f"{prefix}bias_ih_l0{suffix}": np.asarray(p["b_ih"]),
        f"{prefix}bias_hh_l0{suffix}": np.asarray(p["b_hh"]),
    }



def simple_cnn_state(p: Mapping, prefix: str) -> StateDict:
    """SimpleCNN params -> the reference's ``cnn`` Sequential keys."""
    sd = {}
    for i, name in ((0, "conv1"), (2, "conv2"), (4, "conv3")):
        sd.update(_conv(p[name], f"{prefix}cnn.{i}.weight"))
        sd[f"{prefix}cnn.{i}.bias"] = np.asarray(p[name]["bias"])
    fc = _dense(p["fc"], f"{prefix}cnn.6.")
    w = fc[f"{prefix}cnn.6.weight"]  # (out, h·w·C), flattened (h, w, C)
    channels = np.asarray(p["conv3"]["kernel"]).shape[-1]
    side = int(round((w.shape[1] // channels) ** 0.5))
    if side * side * channels != w.shape[1]:
        raise ValueError("simple_cnn_state: the fc's input is not a square map")
    fc[f"{prefix}cnn.6.weight"] = (w.reshape(-1, side, side, channels)
                                   .transpose(0, 3, 1, 2).reshape(w.shape[0], -1))
    sd.update(fc)
    return sd


def instruction_encoder_state(p: Mapping, prefix: str = "instruction_encoder.") -> StateDict:
    """InstructionEncoder / LanguageEncoder params -> the reference's keys:
    the GloVe table or BERT under ``embedding_layer``, the RNN's directions
    under ``encoder_rnn``."""
    if "embedding" in p:
        sd = {prefix + "embedding_layer.weight": np.asarray(p["embedding"])}
    else:
        sd = bert_state(p["embedding_layer"], prefix + "embedding_layer.")
    sd.update(rnn_state(p["fwd"], prefix + "encoder_rnn."))
    if "bwd" in p:
        sd.update(rnn_state(p["bwd"], prefix + "encoder_rnn.", "_reverse"))
    if "encoder2decoder" in p:
        sd.update(_dense(p["encoder2decoder"], prefix + "encoder2decoder."))
    return sd


def seq2seq_state_dict(variables: Mapping) -> StateDict:
    """Seq2SeqPolicy variables -> the port's Seq2SeqPolicy state_dict."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd = instruction_encoder_state(p["instruction_encoder"])
    de, re = p["depth_encoder"], p["rgb_encoder"]
    if "conv1" in de:
        sd.update(simple_cnn_state(de, "depth_encoder."))
    else:
        sd.update(gn_resnet_encoder_state(de["visual_encoder"],
                                          "depth_encoder.visual_encoder."))
        sd.update(_dense(de["visual_fc"], "depth_encoder.visual_fc.1."))
    if "conv1" in re:
        sd.update(simple_cnn_state(re, "rgb_encoder."))
    else:
        sd.update(tv_resnet50_state(re["cnn"], stats["rgb_encoder"]["cnn"], "rgb_encoder.cnn."))
        sd.update(_dense(re["fc"], "rgb_encoder.fc."))
    sd.update(rnn_state(p["state_encoder"], "state_encoder.rnn."))
    if "prev_action_embedding" in p:
        sd["prev_action_embedding.weight"] = np.asarray(p["prev_action_embedding"]["embedding"])
    sd.update(_heads(p, ("progress_monitor", "linear", "stop_linear", "sub_goal_linear")))
    return sd


def rcm_state(p: Mapping, prefix: str) -> StateDict:
    """RCMStateEncoder params -> the port's keys: the kv Denses as 1×1
    Conv1d, ``q_net_kernel`` (H, H/2) and ``q_net_bias`` as the ``q_net``
    Linear, the GRU's w_ih (H + A, 3H) and w_hh under ``rnn``."""
    sd = _conv1d(p["rgb_kv"], prefix + "rgb_kv.")
    sd.update(_conv1d(p["depth_kv"], prefix + "depth_kv."))
    sd.update(_dense({"kernel": p["q_net_kernel"], "bias": p["q_net_bias"]},
                     prefix + "q_net."))
    sd.update(rnn_state(p, prefix + "rnn."))
    return sd


def cma_state_dict(variables: Mapping) -> StateDict:
    """CMAPolicy variables -> the port's CMAPolicy state_dict, with the RCM
    first state encoder when the tree has one (``q_net_kernel``)."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    de, re = p["depth_encoder"], p["rgb_encoder"]
    sd = instruction_encoder_state(p["instruction_encoder"])
    sd.update(gn_resnet_encoder_state(de["visual_encoder"], "depth_encoder.visual_encoder."))
    sd["depth_encoder.spatial_embeddings.weight"] = _spatial_embeddings(de["spatial_embeddings"])
    sd.update(tv_resnet50_state(re["cnn"], stats["rgb_encoder"]["cnn"], "rgb_encoder.cnn."))
    sd["rgb_encoder.spatial_embeddings.weight"] = _spatial_embeddings(re["spatial_embeddings"])
    if "q_net_kernel" in p["state_encoder"]:
        sd.update(rcm_state(p["state_encoder"], "state_encoder."))
    else:
        sd.update(_dense(p["rgb_linear"], "rgb_linear.2."))
        sd.update(_dense(p["depth_linear"], "depth_linear.1."))
        sd.update(rnn_state(p["state_encoder"], "state_encoder.rnn."))
    sd.update(rnn_state(p["second_state_encoder"], "second_state_encoder.rnn."))
    for name in ("rgb_kv", "depth_kv", "text_k"):
        sd.update(_conv1d(p[name], name + "."))
    sd.update(_dense(p["second_state_compress"], "second_state_compress.0."))
    if "prev_action_embedding" in p:
        sd["prev_action_embedding.weight"] = np.asarray(p["prev_action_embedding"]["embedding"])
    sd.update(_heads(p, ("state_q", "text_q", "progress_monitor", "linear", "stop_linear")))
    return sd


# keys the reference modules carry that the flax policies create only when
# something calls them (the progress monitors, Seq2Seq's sub-goal head,
# the BERT encoder's full-sequence projection)
_OPTIONAL = ("progress_monitor.", "sub_goal_linear.", "instruction_encoder.encoder2decoder.")


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


def flat_state_dict(variables: Mapping) -> StateDict:
    """A flat policy's variables -> its port state_dict, CMA or Seq2Seq by
    the tree's layout."""
    if "second_state_encoder" in variables["params"]:
        return cma_state_dict(variables)
    return seq2seq_state_dict(variables)


def load_high_level_seq2seq_weights(policy, variables: Mapping) -> None:
    """Load the JAX HighLevelSeq2SeqPolicy's variables into the port's: its
    tree is a ResNet Seq2Seq's with the ``linear`` head alone, so
    :func:`seq2seq_state_dict` maps it."""
    load_state(policy, seq2seq_state_dict(variables))


def load_flat_weights(policy, variables: Mapping) -> None:
    """Load the JAX variables of a flat policy into the port's module."""
    load_state(policy, flat_state_dict(variables))
