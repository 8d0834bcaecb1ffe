#!/usr/bin/env python3
"""The wide-head attention kernel on one CUDA card, alone: builds
csrc/cross_modal_attn.cu, prints the registers and spills of each instance
of cross_modal_attn_wide_kernel, holds the kernel to the plain version at
the shapes of chip_smoke.py phase 3c (float32 and bf16 in both modes of p,
d_k != d_v, one value a copy), then times it as phase 3c does: float32 at
d = 260 beside the CUDA-core kernel forced and SDPA, float32 at d = 256
forced beside the tensor-core kernel, bf16 at phase 14's shapes (d = 256,
one head, S = 16 and 64) and at d = 256 over 2 heads.

    python3 scripts/wide_attention_probe.py

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
    for kernel, regs, spill in cs.ptxas_usage(logs.get("cross_modal_attn", "")):
        if kernel.startswith("cross_modal_attn_wide"):
            print(f"  {kernel}: {regs} registers, {spill} bytes spill stores")
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    for n, S, h, dtype, dk, dv, offset in (
            (8, 200, 2, f32, 260, 260, 0), (8, 200, 2, f32, 260, 64, 0),
            (8, 200, 2, f32, 512, 512, 0), (8, 100, 2, f32, 260, 260, 1),
            (8, 7, 2, f32, 300, 300, 0), (8, 16, 1, bf16, 256, 256, 0),
            (8, 64, 1, bf16, 256, 256, 0), (8, 200, 2, bf16, 260, 260, 0),
            (8, 70, 2, bf16, 136, 64, 0), (8, 70, 2, bf16, 256, 256, 1)):
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
                      f"{', one element off' if offset else ''}: max_abs_err {err:.3e} "
                      f"(tolerance {tol:.3e})")
                if not err <= tol:
                    print("wide_attention_probe: the kernel disagrees with the plain version")
                    return 1
                worst = max(worst, err)
    cs.time_attention(gen, device, "f32_d260", 200, 200, 200, 2, 260, f32, "d = 260")
    cs.time_attention(gen, device, "f32_d256", 200, 200, 200, 2, 256, f32, "d = 256",
                      force_wide=True)
    for S in (16, 64):
        cs.time_attention(gen, device, f"bf16_s{S}", 200, 200, S, 1, 256, bf16,
                          "phase 14's window")
    cs.time_attention(gen, device, "bf16_d256_h2", 200, 200, 200, 2, 256, bf16, "d = 256")
    print(f"wide_attention_probe: passed, largest error {worst:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
