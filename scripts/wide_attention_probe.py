#!/usr/bin/env python3
"""The wide-head attention kernels and the bf16 key-block kernel's fill
instance on one CUDA card, alone: builds csrc/cross_modal_attn.cu, prints
the registers and spills of each instance of cross_modal_attn_wide_bf16_kernel,
cross_modal_attn_wide_f32_kernel and the fill instance (and fails on a
spill), holds them to the plain version at the shapes of chip_smoke.py
phase 3c and at every copy width (float32 and bf16 in both modes of p,
d_k != d_v, d_k past 272, pointers 0-7 elements off 16 bytes), then times
the rows that PERF.md holds them to: float32 at d = 260 beside SDPA, bf16
at phase 14's shapes (d = 256, one head, S = 16 and 64), at d = 256 and
260 over 2 heads, the fill instance at d = 72 beside the aligned d = 80 and
at d = 64 one element off beside the aligned d = 64.

    python3 scripts/wide_attention_probe.py [--no-times]

About two minutes of card time, the build included.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("wide_attention_probe: no CUDA device", file=sys.stderr)
        return 1
    from robo_vln_tpu_torch.ops import _build, fused_attention

    print(cs.card_line())
    logs = _build.build_all(["cross_modal_attn"])
    spilled = False
    for line in logs.get("cross_modal_attn", "").splitlines():
        if "wgmma" in line or "serializ" in line:
            print("  ptxas: " + line.strip())
    for kernel, regs, spill in cs.ptxas_usage(logs.get("cross_modal_attn", "")):
        if kernel.startswith("cross_modal_attn_wide") or (
                kernel.startswith("cross_modal_attn_bf16_blocks") and kernel.endswith(",1>")):
            print(f"  {kernel}: {regs} registers, {spill} bytes spill stores")
            spilled |= spill > 0
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    shapes = [(8, 200, 2, f32, 260, 260, 0), (8, 200, 2, f32, 260, 64, 0),
              (8, 200, 2, f32, 512, 512, 0), (8, 100, 2, f32, 260, 260, 1),
              (8, 7, 2, f32, 300, 300, 0), (8, 33, 2, f32, 100, 300, 3),
              (8, 16, 1, bf16, 256, 256, 0), (8, 64, 1, bf16, 256, 256, 0),
              (8, 200, 2, bf16, 260, 260, 0), (8, 70, 2, bf16, 136, 64, 0),
              (8, 70, 2, bf16, 256, 256, 1), (8, 40, 2, bf16, 300, 300, 0),
              (8, 40, 2, bf16, 131, 129, 5), (8, 64, 4, bf16, 72, 72, 0),
              (8, 200, 4, bf16, 72, 72, 0), (8, 64, 4, bf16, 128, 64, 0),
              (8, 64, 4, bf16, 60, 60, 0), (8, 70, 4, bf16, 65, 65, 0),
              (8, 70, 4, bf16, 68, 68, 0), (8, 70, 4, bf16, 66, 66, 0),
              (8, 70, 2, bf16, 1, 8, 0)]
    shapes += [(8, 64, 4, bf16, 64, 64, off) for off in range(1, 8)]
    shapes += [(8, 70, 2, bf16, 24, 40, off) for off in (2, 3)]
    for n, S, h, dtype, dk, dv, offset in shapes:
        q, k, v = [torch.randn(offset + n * L * h * d, generator=gen).to(device, dtype)[offset:]
                   .view(n, L, h * d) for L, d in ((200, dk), (S, dk), (S, dv))]
        for float32_p in (False, True) if dtype == bf16 else (False,):
            with cs.p_setting(float32_p):
                got = fused_attention.cross_modal_attn_cuda(q, k, v, h)
                ref = fused_attention.attention_plain(q, k, v, h)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                tol = (cs.bf16_tolerance(cs.ATTN_BF16_TOL, q, k, v, h) if dtype == bf16
                       else cs.ATTN_TOL)
                print(f"  N={n} S={S} h={h} d_k={dk} d_v={dv} {str(dtype)[6:]}"
                      f"{' ' + fused_attention.p_mode() if dtype == bf16 else ''}"
                      f"{f', {offset} elements off' if offset else ''}: max_abs_err {err:.3e} "
                      f"(tolerance {tol:.3e})")
                if not err <= tol:
                    print("wide_attention_probe: the kernel disagrees with the plain version")
                    return 1
                worst = max(worst, err)
    if "--no-times" not in sys.argv[1:]:
        cs.time_attention(gen, device, "f32_d260", 200, 200, 200, 2, 260, f32, "d = 260")
        for S in (16, 64):
            cs.time_attention(gen, device, f"bf16_s{S}", 200, 200, S, 1, 256, bf16,
                              "phase 14's window")
        cs.time_attention(gen, device, "bf16_d256_h2", 200, 200, 200, 2, 256, bf16, "d = 256")
        cs.time_attention(gen, device, "bf16_d260_h2", 200, 200, 200, 2, 260, bf16, "d = 260")
        for d, offset in ((72, 0), (80, 0), (64, 1), (64, 0)):
            cs.time_attention(gen, device, f"bf16_d{d}_{offset}", 200, 200, 64, 4, d, bf16,
                              "the fill instance" if d != 80 and offset or d == 72
                              else "aligned", offset=offset)
    if spilled:
        print("wide_attention_probe: an instance spills")
        return 1
    print(f"wide_attention_probe: passed, largest error {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
