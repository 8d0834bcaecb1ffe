"""Operations and bytes: the chip's published peaks, the least time of each
hand-written kernel's call from its shapes, and the FLOPs of a whole step
counted over the benchmark's own reference on the meta device.

Peaks are one H100 SXM's (NVIDIA's data sheet, dense): 3.35 TB/s of HBM,
67 TFLOP/s float32 on the CUDA cores, 989 TFLOP/s bfloat16 on the tensor
cores.  A kernel's least time is the larger of its bytes over the bandwidth
and its operations over the peak it runs at; each input is read once and
each output written once.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12


def lstm_bound_ms(T, B, H):
    """(bytes ms, operations ms) of one forward call of the LSTM kernel: it
    reads the input gates, the masks, h0, c0 and W_hh and writes the outputs
    and the final h and c; its product is the recurrent one, 2·T·B·H·4H
    float32 operations on the CUDA cores."""
    bytes_moved = 4 * (T * B * 4 * H + T * B + 2 * B * H + 4 * H * H
                       + T * B * H + 2 * B * H)
    flops = 2 * T * B * H * 4 * H
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def lstm_backward_bound_ms(T, B, H):
    """((bytes ms, operations ms) of the whole backward call, (bytes ms,
    operations ms) of the backward kernel's own share).  The call reads the
    input gates, masks, h0, c0, W_hh, the outputs and the three cotangents
    and writes d_gates, d_h0, d_c0 and d_W_hh; its operations are three
    float32 products of 2·T·B·H·4H (the gates recomputed, dh~ = dg·W_hhᵀ in
    the kernel, d_W_hh).  The kernel's share is the dh~ product, with the
    gates, W_hh, the cotangents and masks read and dg, d_h0, d_c0 written."""
    reads = T * B * 4 * H + T * B + 2 * B * H + 4 * H * H + 2 * T * B * H + 2 * B * H
    writes = T * B * 4 * H + 2 * B * H + 4 * H * H
    flops = 2 * T * B * H * 4 * H
    kernel_bytes = 4 * (T * B * 4 * H + T * B + B * H + 4 * H * H + T * B * H + 2 * B * H
                        + T * B * 4 * H + 2 * B * H)
    return ((4 * (reads + writes) / HBM_BYTES_PER_S * 1e3, 3 * flops / F32_FLOP_PER_S * 1e3),
            (kernel_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3))


def attn_bound_ms(N, Lq, S, heads, d, itemsize, flop_per_s):
    """(bytes ms, operations ms) of one cross-modal attention call: q and
    the output (N, Lq, h·d), k and v (N, S, h·d), each moved once; q·kᵀ and
    p·v, 2·N·h·Lq·S·2d operations."""
    bytes_moved = itemsize * (N * Lq * heads * d * 2 + N * S * heads * d * 2)
    flops = 2 * N * heads * Lq * S * (d + d)
    return bytes_moved / HBM_BYTES_PER_S * 1e3, flops / flop_per_s * 1e3


def least_ms(bound):
    """The least time of a (bytes ms, operations ms) pair."""
    return max(bound)


def count_flops(fn, *args, **kwargs) -> int:
    """The floating-point operations FlopCounterMode counts in ``fn`` (2 a
    multiply-add; matrix products and convolutions, forward and backward)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def meta_like(tree):
    """A dict of tensors (or a tensor) as meta tensors of the same shapes
    and dtypes."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
