"""Random weights from a seed, made on the device in one draw.

One float32 normal draw of every leaf's elements, from a generator on the
device seeded with the run's seed, is cut into the leaves by name and
shape: a norm's one-dimensional weight and a running variance are ones, any
other one-dimensional leaf (biases, running means) zeros, every matrix of
BERT N(0, 0.02) (BERT's published initializer: at the fan-in scale its
twelve post-LN layers amplify a rounding of the input, so bfloat16 and
float32 part by the whole width of the output), any other embedding table
N(0, 1), every other matrix or kernel N(0, 1 / fan-in).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _scale(name: str, shape) -> float:
    if ".embeddings." in name or ".encoder.layer." in name:  # BERT's modules
        return 0.02
    if "embedding" in name:
        return 1.0
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape)."""
    drawn = [n for n, s in shapes.items() if len(s) > 1]
    total = sum(math.prod(shapes[n]) for n in drawn)
    flat = torch.randn(total, generator=generator(seed, device), device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) > 1:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape).mul_(_scale(name, shape))
            at += size
        elif name.endswith(("running_var", ".weight")):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def shapes_of(*prefixed_modules) -> Dict[str, Tuple[int, ...]]:
    """{prefix + name: shape} of the state dicts of (prefix, module) pairs."""
    return {prefix + k: tuple(v.shape) for prefix, m in prefixed_modules
            for k, v in m.state_dict().items()}
