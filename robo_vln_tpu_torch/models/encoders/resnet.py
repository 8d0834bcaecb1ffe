"""ResNet trunks (counterpart of robo_vln_tpu/models/encoders/resnet.py:31-283).

* :class:`GNResNetEncoder` — the DDPPO GroupNorm ResNet50 over depth (base
  planes 32, 16 groups, Bottleneck [3, 4, 6, 3]) and its 3×3 compression conv
  to 2048 features (8×8×32 for a 256 px input).
* :class:`TVResNet50` — the torchvision ResNet50 over rgb, BatchNorm frozen in
  eval mode, up to layer4 (7×7×2048 for a 224 px input).

Built from ``nn`` primitives; parameter names follow the reference's torch
modules (habitat's ``backbone.layer1.0.convs.3.weight``, torchvision's
``layer1.0.bn2.running_var``).  Tensors are NCHW here (an NHWC input permuted
to NCHW is already channels-last in memory, which cuDNN prefers).  Convs run
in the compute dtype; GroupNorm runs in float32 with flax's eps=1e-6 (torch's
default is 1e-5) and the bottleneck residual is added in float32, as in JAX;
the frozen BatchNorm is an affine in the compute dtype with eps=1e-5.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.profiling import module_range

GN_EPS = 1e-6  # flax nn.GroupNorm default


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(kernel=3, stride=2, padding=1); the padding counts as -inf."""
    return F.max_pool2d(x, 3, 2, 1)


def conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding)


def group_norm(x: torch.Tensor, m: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm in float32 (output float32)."""
    return F.group_norm(x.float(), m.num_groups, m.weight, m.bias, m.eps)


def _conv(i: int, o: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(i, o, k, stride, k // 2, bias=False)


def _gn(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=GN_EPS)


class FrozenBatchNorm(nn.Module):
    """BatchNorm in eval mode: y = (x - mean) / sqrt(var + eps) * w + b."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class GNBottleneck(nn.Module):
    """habitat ddppo Bottleneck: 1×1 -> gn -> relu -> 3×3(stride) -> gn ->
    relu -> 1×1 -> gn, plus the (downsampled) skip."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, ngroups: int, stride: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        out = planes * self.expansion
        self.convs = nn.Sequential(
            _conv(inplanes, planes, 1), _gn(ngroups, planes), nn.ReLU(True),
            _conv(planes, planes, 3, stride), _gn(ngroups, planes), nn.ReLU(True),
            _conv(planes, out, 1), _gn(ngroups, out),
        )
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                _conv(inplanes, out, 1, stride), _gn(ngroups, out)
            )

    def forward(self, x):
        dt, c = self.compute_dtype, self.convs
        y = F.relu(group_norm(conv(x, c[0], dt), c[1])).to(dt)
        y = F.relu(group_norm(conv(y, c[3], dt), c[4])).to(dt)
        y = group_norm(conv(y, c[6], dt), c[7])
        identity = x
        if self.downsample is not None:
            identity = group_norm(conv(x, self.downsample[0], dt), self.downsample[1])
        return F.relu(y + identity.float()).to(dt)


class _GNResNet(nn.Module):
    def __init__(self, in_channels, base_planes, ngroups, blocks, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Sequential(
            nn.Conv2d(in_channels, base_planes, 7, 2, 3, bias=False),
            _gn(ngroups, base_planes), nn.ReLU(True),
        )
        inplanes, planes = base_planes, base_planes
        for li, n in enumerate(blocks):
            layer = []
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                layer.append(GNBottleneck(inplanes, planes, ngroups, stride, compute_dtype))
                inplanes = planes * GNBottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            planes *= 2
        self.num_layers = len(blocks)
        self.final_channels = inplanes

    def forward(self, x):
        dt = self.compute_dtype
        x = F.relu(group_norm(conv(x, self.conv1[0], dt), self.conv1[1])).to(dt)
        x = max_pool_3x3_s2(x)
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        return x


class GNResNetEncoder(nn.Module):
    """Backbone + compression: (N, 1, 256, 256) depth -> (N, 32, 8, 8).  The
    compression width follows ``spatial_size`` (256) whatever the input's
    size, as in the reference."""

    def __init__(self, in_channels: int = 1, base_planes: int = 32,
                 ngroups: int = 16, spatial_size: int = 256,
                 blocks: Sequence[int] = (3, 4, 6, 3), compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.backbone = _GNResNet(in_channels, base_planes, ngroups, blocks, compute_dtype)
        final_spatial = spatial_size // 32
        self.compression_channels = int(round(2048 / final_spatial**2))
        self.compression = nn.Sequential(
            _conv(self.backbone.final_channels, self.compression_channels, 3),
            _gn(1, self.compression_channels), nn.ReLU(True),
        )

    @module_range("GNResNetEncoder")
    def forward(self, x):
        dt = self.compute_dtype
        x = self.backbone(x.to(dt))
        x = group_norm(conv(x, self.compression[0], dt), self.compression[1])
        return F.relu(x).to(dt)


class TVBottleneck(nn.Module):
    """torchvision Bottleneck with frozen BatchNorm."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        out = planes * self.expansion
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                _conv(inplanes, out, 1, stride), FrozenBatchNorm(out)
            )

    def forward(self, x):
        dt = self.compute_dtype
        y = F.relu(self.bn1(conv(x, self.conv1, dt)))
        y = F.relu(self.bn2(conv(y, self.conv2, dt)))
        y = self.bn3(conv(y, self.conv3, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv(x, self.downsample[0], dt))
        return F.relu(y + identity)


class TVResNet50(nn.Module):
    """(N, 3, 224, 224) in [0, 1] -> (N, 2048, 7, 7)."""

    def __init__(self, blocks: Sequence[int] = (3, 4, 6, 3), compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        inplanes, planes = 64, 64
        for li, n in enumerate(blocks):
            layer = []
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                layer.append(TVBottleneck(inplanes, planes, stride, compute_dtype))
                inplanes = planes * TVBottleneck.expansion
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))
            planes *= 2
        self.num_layers = len(blocks)

    @module_range("TVResNet50")
    def forward(self, x):
        dt = self.compute_dtype
        x = max_pool_3x3_s2(F.relu(self.bn1(conv(x, self.conv1, dt))))
        for li in range(self.num_layers):
            x = getattr(self, f"layer{li + 1}")(x)
        return x
