"""The frozen trunks of the reference, as plain functions of a weight dict:
torchvision's ResNet50 over rgb (frozen BatchNorm, up to layer4), habitat
DD-PPO's GroupNorm ResNet50 over depth with its compression conv, and
BERT-base.  Key names are the published modules' (torchvision, habitat,
HuggingFace's ``BertModel``) under the prefix given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Arith, layer_norm, multi_head_attention

BN_EPS = 1e-5
GN_EPS = 1e-6  # flax's GroupNorm default, which the agent was trained with
BERT_EPS = 1e-12
STAGE_STRIDES = (1, 2, 2, 2)


def _bn(x, w, p):
    scale = w[p + ".weight"] * torch.rsqrt(w[p + ".running_var"] + BN_EPS)
    shift = w[p + ".bias"] - w[p + ".running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def _gn(x, w, p, groups):
    return F.group_norm(x, groups, w[p + ".weight"], w[p + ".bias"], GN_EPS)


def _blocks(w, p, first):
    """Bottleneck counts of each stage, read from the keys: ``first`` names
    a block's first conv."""
    counts = []
    for stage in range(1, 5):
        n = 0
        while f"{p}layer{stage}.{n}.{first}" in w:
            n += 1
        counts.append(n)
    return counts


def tv_resnet50(A: Arith, w, p, rgb):
    """rgb (N, H, W, 3) uint8 -> (N, H/32, W/32, 2048); the input is rgb / 255
    with no mean or deviation taken off."""
    x = rgb.float().permute(0, 3, 1, 2) / 255.0
    x = F.relu(_bn(A.conv(x, w[p + "conv1.weight"], 2, 3), w, p + "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(_blocks(w, p, "conv1.weight")):
        for i in range(n):
            b = f"{p}layer{stage + 1}.{i}."
            s = STAGE_STRIDES[stage] if i == 0 else 1
            y = F.relu(_bn(A.conv(x, w[b + "conv1.weight"]), w, b + "bn1"))
            y = F.relu(_bn(A.conv(y, w[b + "conv2.weight"], s, 1), w, b + "bn2"))
            y = _bn(A.conv(y, w[b + "conv3.weight"]), w, b + "bn3")
            if b + "downsample.0.weight" in w:
                x = _bn(A.conv(x, w[b + "downsample.0.weight"], s), w, b + "downsample.1")
            x = F.relu(y + x)
    return x.permute(0, 2, 3, 1)


def gn_resnet50(A: Arith, w, p, depth, groups=16):
    """depth (N, H, W, 1) -> (N, H/32, W/32, C), C = 2048 / (H/32)²: the
    backbone (base width 32), then the 3×3 compression conv, GroupNorm of one
    group, ReLU."""
    x = depth.float().permute(0, 3, 1, 2)
    bb = p + "backbone."
    x = F.relu(_gn(A.conv(x, w[bb + "conv1.0.weight"], 2, 3), w, bb + "conv1.1", groups))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in enumerate(_blocks(w, bb, "convs.0.weight")):
        for i in range(n):
            b = f"{bb}layer{stage + 1}.{i}."
            s = STAGE_STRIDES[stage] if i == 0 else 1
            y = F.relu(_gn(A.conv(x, w[b + "convs.0.weight"]), w, b + "convs.1", groups))
            y = F.relu(_gn(A.conv(y, w[b + "convs.3.weight"], s, 1), w, b + "convs.4", groups))
            y = _gn(A.conv(y, w[b + "convs.6.weight"]), w, b + "convs.7", groups)
            if b + "downsample.0.weight" in w:
                x = _gn(A.conv(x, w[b + "downsample.0.weight"], s), w, b + "downsample.1",
                        groups)
            x = F.relu(y + x)
    x = F.relu(_gn(A.conv(x, w[p + "compression.0.weight"], 1, 1), w, p + "compression.1", 1))
    return x.permute(0, 2, 3, 1)


def bert(A: Arith, w, p, ids, heads):
    """BERT's last hidden state (B, L, hidden) over ids (B, L): no attention
    mask, token type 0, post-LN layers, exact GELU."""
    e = p + "embeddings."
    L = ids.shape[1]
    x = (w[e + "word_embeddings.weight"][ids.long()] + w[e + "position_embeddings.weight"][:L]
         + w[e + "token_type_embeddings.weight"][0])
    x = layer_norm(x, w[e + "LayerNorm.weight"], w[e + "LayerNorm.bias"], BERT_EPS)
    n = 0
    while f"{p}encoder.layer.{n}.attention.self.query.weight" in w:
        b = f"{p}encoder.layer.{n}."

        def lin(name, v):
            return A.linear(v, w[b + name + ".weight"], w[b + name + ".bias"])

        att = multi_head_attention(A, lin("attention.self.query", x), lin("attention.self.key", x),
                                   lin("attention.self.value", x), heads)
        x = layer_norm(x + lin("attention.output.dense", att),
                       w[b + "attention.output.LayerNorm.weight"],
                       w[b + "attention.output.LayerNorm.bias"], BERT_EPS)
        y = lin("output.dense", F.gelu(lin("intermediate.dense", x)))
        x = layer_norm(x + y, w[b + "output.LayerNorm.weight"], w[b + "output.LayerNorm.bias"],
                       BERT_EPS)
        n += 1
    return x
