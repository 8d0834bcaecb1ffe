"""Depth and RGB observation encoders (counterpart of
robo_vln_tpu/models/encoders/visual.py:35-155).

* :class:`DepthEncoder` (the reference's VlnResnetDepthEncoder): GroupNorm
  ResNet50 over depth; vector mode Flatten -> Linear -> ReLU (flattened
  channel-major, as torch's Flatten sees NCHW), spatial mode appends a 64-dim
  per-position embedding to each token.
* :class:`RGBEncoder` (the reference's TorchVisionResNet50): frozen ResNet50
  over rgb / 255 — no mean/std normalisation, a reference quirk kept; vector
  mode avgpool -> Linear -> ReLU, spatial mode adaptive-pools 7×7 to 4×4
  tokens and appends the embedding.

Observations keep the JAX package's layouts: frames (N, H, W, C); trunk
features ``rgb_features`` / ``depth_features`` (N, h, w, C) when a shared
trunk pass (models.make_shared_trunk_fn) has computed them, in which case the
encoder skips its own trunk.  An encoder's own (frozen) trunk runs under
``no_grad``.  Spatial outputs are (N, S, C) token-major.

The spatial tables keep the reference's (S, 64) ``nn.Embedding`` weight, and
the forward reproduces its row-major ``.view(1, -1, h, w)``: channel k of
token p reads ``weight.flatten()[k * S + p]``.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..transformer import linear
from .resnet import GNResNetEncoder, TVResNet50


def visual_obs(observations: Dict[str, torch.Tensor], key: str, n: int):
    """Encoder input for one modality with time folded into batch: the trunk
    features when present, the raw frames otherwise."""
    fkey = f"{key}_features"
    k = fkey if fkey in observations else key
    v = observations[k]
    return {k: v.reshape((n,) + tuple(v.shape[2:]))}


def visual_ref(observations: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The tensor that carries the (B, T) leading shape."""
    return observations["rgb"] if "rgb" in observations else observations["rgb_features"]


def _scrambled_table(emb: nn.Embedding) -> torch.Tensor:
    """(S, D) token-major table of the reference's ``.view(1, -1, h, w)``."""
    return emb.weight.reshape(emb.embedding_dim, emb.num_embeddings).t()


class DepthEncoder(nn.Module):
    def __init__(self, output_size: int = 128, spatial_output: bool = False,
                 input_size: int = 256, blocks=(3, 4, 6, 3),
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.spatial_output = spatial_output
        self.visual_encoder = GNResNetEncoder(blocks=blocks, compute_dtype=compute_dtype)
        n_tokens = (input_size // 32) ** 2
        channels = self.visual_encoder.compression_channels
        if spatial_output:
            self.spatial_embeddings = nn.Embedding(n_tokens, 64)
        else:
            self.visual_fc = nn.Sequential(
                nn.Flatten(), nn.Linear(channels * n_tokens, output_size), nn.ReLU(True)
            )

    def forward(self, observations):
        if "depth_features" in observations:
            x = observations["depth_features"]
        else:
            with torch.no_grad():
                depth = observations["depth"].permute(0, 3, 1, 2)
                x = self.visual_encoder(depth).permute(0, 2, 3, 1)
        b, h, w, c = x.shape
        if self.spatial_output:
            tokens = x.reshape(b, h * w, c)
            emb = _scrambled_table(self.spatial_embeddings).to(tokens.dtype)
            return torch.cat([tokens, emb[None].expand(b, -1, -1)], dim=-1)
        flat = x.permute(0, 3, 1, 2).reshape(b, -1)  # channel-major
        return F.relu(linear(flat, self.visual_fc[1], self.compute_dtype))


class RGBEncoder(nn.Module):
    def __init__(self, output_size: int = 256, spatial_output: bool = False,
                 blocks=(3, 4, 6, 3), compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.spatial_output = spatial_output
        self.cnn = TVResNet50(blocks=blocks, compute_dtype=compute_dtype)
        if spatial_output:
            self.spatial_embeddings = nn.Embedding(16, 64)
        else:
            self.fc = nn.Linear(2048, output_size)

    def forward(self, observations):
        if "rgb_features" in observations:
            feat = observations["rgb_features"]  # (N, h, w, C) or (N, S, C)
        else:
            with torch.no_grad():
                rgb = observations["rgb"].to(self.compute_dtype) / 255.0
                feat = self.cnn(rgb.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        b = feat.shape[0]
        if self.spatial_output:
            if feat.dim() == 4:
                # torch's bins, overlapping for 7 -> 4, as the JAX pooling
                # matrices; float32, as their matmul promotes to it
                pooled = F.adaptive_avg_pool2d(feat.permute(0, 3, 1, 2).float(), (4, 4))
                feat = pooled.permute(0, 2, 3, 1).reshape(b, 16, -1)
            emb = _scrambled_table(self.spatial_embeddings).to(feat.dtype)
            return torch.cat([feat, emb[None].expand(b, -1, -1)], dim=-1)
        if feat.dim() == 4:
            feat = feat.mean(dim=(1, 2))
        return F.relu(linear(feat, self.fc, self.compute_dtype))
