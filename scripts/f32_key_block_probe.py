#!/usr/bin/env python3
"""The float32 key-block attention kernels (in csrc/cross_modal_attn.cu,
cross_modal_attn_f32tc_blocks_kernel on mma.sync at D = 32 and 64,
cross_modal_attn_f32wg_blocks_kernel on warpgroup MMA at D = 128 and 256)
on one CUDA card, alone: builds the attention source, prints each
instance's registers and spills and any note of ptxas about its warpgroup
MMA (and fails on a spill or a serialized wgmma), holds the kernels to the
plain version (within chip_smoke.ATTN_TOL) at the float32 key-block
shapes of chip_smoke.py phases 3b and 3c (every instance D = 32, 64, 128
and 256, d_k != d_v across the halves of a D = 256 cluster, S off a
multiple of the key block, partial query tiles, pointers one float off 16
bytes) and at phase 14's float32 shapes, then times the rows PERF.md holds
it to, at N = 200, Lq = 200, inputs rotated out of L2, beside the plain
version and SDPA: (a) S = 144, h = 4, d = 64; (b) S = 200, h = 4,
d = 128; (c) S = 500, h = 4, d = 60; (e) S = 200, h = 2, d = 256; and
phase 14's h = 1, d = 256 at S = 16 and 64.

    python3 scripts/f32_key_block_probe.py [--no-times]

About a minute of card time after the build.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

# N, S, heads, d_k, d_v, offset (floats off 16 bytes); Lq is 200 unless a
# seventh entry gives it
SHAPES = [(200, 144, 4, 64, 64, 0), (200, 200, 4, 128, 128, 0), (8, 500, 4, 64, 64, 0),
          (8, 500, 4, 60, 60, 0), (8, 500, 4, 61, 61, 0), (8, 300, 4, 64, 64, 1),
          (200, 200, 2, 256, 256, 0), (8, 16, 2, 256, 256, 1), (8, 16, 1, 256, 256, 0),
          (8, 64, 1, 256, 256, 0), (2, 129, 2, 64, 64, 0, 50), (3, 300, 2, 96, 40, 0, 140),
          (2, 129, 2, 61, 33, 0, 130), (2, 16, 2, 200, 200, 0, 40), (2, 129, 2, 60, 136, 0, 30),
          (2, 100, 2, 125, 127, 0, 130), (1, 1, 2, 256, 1, 0, 1), (2, 200, 2, 16, 16, 0, 20),
          (2, 70, 2, 200, 100, 0, 33), (2, 70, 2, 100, 200, 0, 33), (2, 70, 2, 129, 1, 0, 65),
          (2, 70, 2, 1, 255, 3, 65), (2, 1000, 1, 32, 32, 0, 7), (4, 16, 4, 64, 64, 0),
          (4, 64, 4, 64, 64, 0), (2, 65, 3, 128, 128, 2, 129)]


def main():
    if not torch.cuda.is_available():
        print("f32_key_block_probe: no CUDA device", file=sys.stderr)
        return 1
    from robo_vln_tpu_torch.ops import _build, fused_attention

    print(cs.card_line())
    log = _build.build_all(["cross_modal_attn"]).get("cross_modal_attn", "")
    bad = False
    for line in log.splitlines():
        if "serializ" in line:
            print("  ptxas: " + line.strip())
            bad = True
    for kernel, regs, spill in cs.ptxas_usage(log):
        if kernel.startswith(("cross_modal_attn_f32tc_blocks", "cross_modal_attn_f32wg_blocks")):
            print(f"  {kernel}: {regs} registers, {spill} bytes spill stores")
            bad |= spill > 0
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    for shape in SHAPES:
        n, S, h, dk, dv, offset = shape[:6]
        lq = shape[6] if len(shape) > 6 else 200
        q, k, v = [torch.randn(offset + n * L * h * d, generator=gen).to(device)[offset:]
                   .view(n, L, h * d) for L, d in ((lq, dk), (S, dk), (S, dv))]
        with cs.f32_key_blocks_everywhere():
            before = fused_attention.f32_key_block_launches
            got = fused_attention.cross_modal_attn_cuda(q, k, v, h)
            blocks = fused_attention.f32_key_block_launches - before
        ref = fused_attention.attention_plain(q, k, v, h)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        print(f"  N={n} Lq={lq} S={S} h={h} d_k={dk} d_v={dv}"
              f"{f', {offset} floats off' if offset else ''}: max_abs_err {err:.3e} "
              f"(tolerance {cs.ATTN_TOL:.0e}), {blocks} key-block launch")
        if not err <= cs.ATTN_TOL or blocks != 1:
            print("f32_key_block_probe: the kernel disagrees with the plain version")
            return 1
        worst = max(worst, err)
    if "--no-times" not in sys.argv[1:]:
        f32 = torch.float32
        for prefix, S, h, d, what in (("a", 144, 4, 64, "(a)"), ("b", 200, 4, 128, "(b)"),
                                      ("c", 500, 4, 60, "(c)"), ("e", 200, 2, 256, "(e)"),
                                      ("p14_s16", 16, 1, 256, "phase 14, rgb"),
                                      ("p14_s64", 64, 1, 256, "phase 14, depth")):
            cs.time_attention(gen, device, prefix, 200, 200, S, h, d, f32, what)
    if bad:
        print("f32_key_block_probe: an instance spills or has its wgmma serialized")
        return 1
    print(f"f32_key_block_probe: passed, largest error {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
