#!/usr/bin/env python3
"""Probe what holds the bf16 key-block attention kernel on one CUDA card.

    python3 scripts/attention_probe.py

Builds into build/probe/ and prints, after the card's name and power limit:

1. The peak rate of ``mma.sync`` m16n8k16 with bf16 inputs and float32
   accumulators on this card: every SM runs warps of independent products,
   at 4 to 32 warps an SM.
2. One bf16 call at N=200, Lq=200, h=4 at S=144, d=64 and S=200, d=128,
   inputs rotated out of L2: the key-block kernel through its C entry, the
   same kernel built with its global loads turned into zero-fills (the
   copy's source size 0, so it moves no bytes but its output), and
   ``scaled_dot_product_attention`` by each backend PyTorch offers.
3. The kernel and SDPA at S = 144, 256, 512 and 1024 (d = 64), for their
   cost per key.

The last line is one JSON object with every number.  Exits non-zero
without a CUDA card.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from robo_vln_tpu_torch.ops import _build, fused_attention  # noqa: E402

PROBE_DIR = _build.BUILD_DIR.parent / "probe"
MMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int chains>
__global__ void mma_loop(float* out, int iters) {
  float c[chains][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < chains; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < chains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_loop16(float* out, int blocks, int iters, void* stream) {
  mma_loop<16><<<blocks, 128, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
# the key-block kernel's three copies from global memory, and their zero-fills
LOADS = {
    "cp_async16(q_s + r * P + c, ok ? qb + (size_t)r * ld + c : q, ok);":
        "cp_async16(q_s + r * P + c, q, false);",
    "cp_async16(k_s + r * P + c, ok ? kb + at : kb, ok);": "cp_async16(k_s + r * P + c, kb, false);",
    "cp_async16(v_s + r * P + c, ok ? vb + at : vb, ok);": "cp_async16(v_s + r * P + c, vb, false);",
}


def nvcc(source, name):
    """Compile ``source`` into build/probe/lib<name>.so and load it."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    cu, so = PROBE_DIR / f"{name}.cu", PROBE_DIR / f"lib{name}.so"
    cu.write_text(source)
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def load_free_source():
    """csrc/cross_modal_attn.cu with the key-block kernel's loads zero-filled."""
    src = (_build.CSRC / "cross_modal_attn.cu").read_text()
    start = src.index("cross_modal_attn_bf16_blocks_kernel(const")
    end = src.index("int launch_bf16_blocks(")
    body = src[start:end]
    for load, zero in LOADS.items():
        if body.count(load) != 1:
            raise RuntimeError(f"attention_probe: the kernel's load {load!r} moved")
        body = body.replace(load, zero)
    return src[:start] + body + src[end:]


def entry_call(fn, heads, d):
    """The bf16 key-block route (code BF16_KEY_BLOCKS) through a C entry."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

    def call(q, k, v):
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), q.shape[0],
                 q.shape[1], k.shape[1], heads, d, d, fused_attention.BF16_KEY_BLOCKS,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"attention_probe: CUDA error {err}")
        return out
    return call


def main():
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 1
    from torch.nn.attention import SDPBackend, sdpa_kernel

    card = chip_smoke.card_line()
    print(card)
    result = {"card": card}
    _build.build_all(["cross_modal_attn"])
    kernel_fn = _build.load("cross_modal_attn").cross_modal_attn
    load_free_fn = nvcc(load_free_source(), "attention_load_free").cross_modal_attn
    mma = nvcc(MMA_SOURCE, "mma_peak").mma_loop16
    mma.restype = ctypes.c_int
    mma.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 8 * 128, device="cuda")
    iters = 4096
    for warps in (4, 8, 16, 32):
        blocks = sms * warps // 4
        t = statistics.median(chip_smoke.time_ms(
            lambda: mma(out.data_ptr(), blocks, iters, torch.cuda.current_stream().cuda_stream),
            reps=5, inner=3))
        rate = 2 * 16 * 8 * 16 * 16 * iters * blocks * 4 / t / 1e9
        print(f"mma.sync m16n8k16 bf16, {warps} warps an SM: {rate:.1f} TFLOP/s")
        result[f"mma_sync_tflops_{warps}_warps"] = rate

    gen = torch.Generator().manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    backends = {"default": None, "flash": SDPBackend.FLASH_ATTENTION,
                "efficient": SDPBackend.EFFICIENT_ATTENTION, "cudnn": SDPBackend.CUDNN_ATTENTION}

    def timed(fn, sets):
        return statistics.median(chip_smoke.time_ms(chip_smoke.rotated(fn, sets)))

    for S, d, shapes in ((144, 64, (144, 256, 512, 1024)), (200, 128, (200,))):
        for s in shapes:
            sets = [[torch.randn(200, L, 4 * d, generator=gen).to("cuda", torch.bfloat16)
                     for L in (200, s, s)] for _ in range(chip_smoke.L2_ROTATION)]
            views = [[t.view(200, t.shape[1], 4, d).transpose(1, 2) for t in ts] for ts in sets]
            tag = f"S={s} d={d}"
            result[f"{tag} kernel_ms"] = timed(entry_call(kernel_fn, 4, d), sets)
            if s == S:
                result[f"{tag} load_free_ms"] = timed(entry_call(load_free_fn, 4, d), sets)
            for name, backend in backends.items():
                if backend is None:
                    result[f"{tag} sdpa_{name}_ms"] = timed(sdpa, views)
                elif s == S:
                    with sdpa_kernel([backend]):
                        result[f"{tag} sdpa_{name}_ms"] = timed(sdpa, views)
            print(tag, {k.split(" ")[2]: round(v, 4) for k, v in result.items()
                        if k.startswith(tag + " ")})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
